"""Voxel and point feature encoders (readers): counterpart of
``partner_tpu/models/readers.py``.

- :class:`VoxelFeatureExtractorV3`: the mean of the (<= max_points) rows
  stored per hard voxel; on the dynamic path's (B, N, C) means it only
  slices the channels.
- :class:`DynamicVoxelEncoderV1`: the identity on
  :func:`ops.voxelize.dynamic_voxelize`'s means, sliced to the channels.
- :class:`PFNLayer`: Dense (no bias), ``MaskedBatchNorm`` and ReLU over
  per-point features; the pillar max is its caller's.

The first two have no parameters. ``DynamicPFNet`` and
``PillarFeatureNet``, the pillar encoders, are in ``models/pillar.py``.
"""

import torch
import torch.nn as nn

from .layers import Dense, MaskedBatchNorm
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


@READERS.register_module(name="PFNLayer")
class PFNLayer(nn.Module):
    """Dense (no bias) -> ``MaskedBatchNorm`` -> ReLU over per-point
    features (``partner_tpu/models/readers.py:47-59``); ``last`` is kept
    for the config's sake, and the layer does the same either way."""

    def __init__(self, in_features, features, last=False):
        super().__init__()
        self.last = last
        self.Dense_0 = Dense(in_features, features, use_bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def forward(self, x, mask):
        """x (P, C), mask (P,) bool -> (P, features), 0 on masked rows."""
        return torch.relu(self.MaskedBatchNorm_0(self.Dense_0(x), mask))
