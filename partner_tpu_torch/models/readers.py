"""Voxel feature encoders (readers): counterpart of the parameter-free
half of ``partner_tpu/models/readers.py``.

- :class:`VoxelFeatureExtractorV3`: the mean of the (<= max_points) rows
  stored per hard voxel; on the dynamic path's (B, N, C) means it only
  slices the channels.
- :class:`DynamicVoxelEncoderV1`: the identity on
  :func:`ops.voxelize.dynamic_voxelize`'s means, sliced to the channels.

Neither has parameters. ``PFNLayer``, ``DynamicPFNet`` and
``PillarFeatureNet`` wait for ``pillar.py`` (ROADMAP.md queue 1, off the
main path).
"""

import torch
import torch.nn as nn

from .registry import READERS


@READERS.register_module(name="VoxelFeatureExtractorV3")
class VoxelFeatureExtractorV3(nn.Module):
    """Mean of the (<= max_points) points stored per voxel."""

    def __init__(self, num_input_features=7):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels, num_points=None):
        """voxels (B, N, K, C) and num_points (B, N) -> (B, N, C') means;
        (B, N, C) dynamic means -> sliced to C'."""
        n = self.num_input_features
        if voxels.dim() == 3:
            return voxels[..., :n]
        s = voxels[..., :n].sum(dim=2)
        return s / torch.clamp(num_points, min=1)[..., None].to(s.dtype)


@READERS.register_module(name="DynamicVoxelEncoderV1")
class DynamicVoxelEncoderV1(nn.Module):
    """Identity over the dynamic voxelizer's mean features."""

    def __init__(self, num_input_features=7):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxel_features):
        return voxel_features[..., : self.num_input_features]
