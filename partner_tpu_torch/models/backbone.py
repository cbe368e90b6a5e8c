"""SpMiddleResNetFHD (counterpart of ``partner_tpu/models/backbone.py``):
the sparse 3D ResNet middle extractor of the reference's spconv backbone,
on the gather-matmul sparse conv of :mod:`.sparse`.

    conv_input: SubM 3^3, Cin -> 16
    conv1: 2x SparseBasicBlock(16)                       @ full res
    conv2: SparseConv s2 16 -> 32 + 2x block             @ 1/2
    conv3: SparseConv s2 32 -> 64 + 2x block             @ 1/4
    conv4: SparseConv s2 64 -> 128 (z-pad per extra_sp_shape) + 2x block
    extra_conv: SparseConv (3,1,1) s(2,1,1) p0 128 -> 128 (z squeeze)
    -> dense (B, nz', ny, nx, 128) -> (B, ny, nx, nz' * 128)

The sparse shape is the voxel grid reversed, (z, azimuth, range), plus
the ``extra_sp_shape`` padding rows. Everything runs in float32, as in
JAX. The output is NHWC, (B, n_az/8, n_r/8, nz' * 128), the channel
index ``c * nz' + z`` (torch's ``view(N, C * D, H, W)``).

The rows are sorted at entry: each sample's valid rows by linear cell id,
stably, masked rows last. The ``"binary"`` index method needs that order,
which the on-device ``dynamic_voxelize`` gives and the hard voxelizer's
first-come rows do not. JAX's backbone takes the rows as they come, so on
first-come rows its ``"binary"`` method builds wrong neighbour maps (its
``"dense"`` method does not depend on the order); the port gives there
what JAX's ``"dense"`` method gives (ROADMAP.md §3). The BEV does not
depend on the row order. The JAX backbone's per-stage ``multi_scale``
grids feed only the segmentation heads, which are not ported.
"""

import torch
import torch.nn as nn

from .registry import BACKBONES
from .sparse import (SparseBasicBlock, SparseDownBlock, SparseGrid,
                     SubMBlock, _lin_ids, build_subm_neighbor_map,
                     build_subm_neighbor_map_dense, sparse_to_dense,
                     strided_out_shape)


def sort_rows(features, coords, mask, shape):
    """Each sample's rows sorted by linear cell id, stably, the masked rows
    last -> (features, coords, mask)."""
    lin, _ = _lin_ids(coords, mask, shape)
    order = torch.sort(lin, dim=1, stable=True).indices
    take = (lambda t: torch.take_along_dim(
        t, order.reshape(order.shape + (1,) * (t.dim() - 2)), dim=1))
    return take(features), take(coords), take(mask)


@BACKBONES.register_module(name="SpMiddleResNetFHD")
class SpMiddleResNetFHD(nn.Module):
    """``caps``: per-stage voxel capacities (full, 1/2, 1/4, 1/8), 0 for the
    input's N (the full-resolution entry is not read, as in JAX).
    ``index_method``: ``"binary"`` (binary search of the sorted ids; the
    default) or ``"dense"`` (grid-sized index tables).
    ``input_shape`` is the (n_r, n_az, n_z) grid; the BEV width,
    ``out_features``, depends on its z extent."""

    def __init__(self, num_input_features=7, ds_factor=8,
                 extra_sp_shape=(1, 0, 0), caps=(0, 0, 0, 0),
                 index_method="binary", input_shape=None, **kwargs):
        super().__init__()
        if index_method not in ("binary", "dense"):
            raise ValueError(f"index_method {index_method!r}: 'binary' or "
                             "'dense'")
        self.extra_sp_shape = tuple(int(e) for e in extra_sp_shape)
        self.caps = tuple(caps)
        self.index_method = index_method
        ez = self.extra_sp_shape[0]
        # conv4's z padding depends on extra_sp_shape (scn.py:140-148)
        zpad = 0 if ez else 1
        down = dict(index_method=index_method)
        self.conv_input = SubMBlock(num_input_features, 16)
        self.conv1_0 = SparseBasicBlock(16)
        self.conv1_1 = SparseBasicBlock(16)
        # each stage's capacity is resolved per call (0: the input's N)
        self.conv2 = SparseDownBlock(16, 32, **down)
        self.conv3 = SparseDownBlock(32, 64, **down)
        self.conv4 = SparseDownBlock(64, 128, padding=(zpad, 1, 1), **down)
        self.extra_conv = SparseDownBlock(
            128, 128, kernel=(3, 1, 1), stride=(2, 1, 1), padding=(0, 0, 0),
            num_res=0, **down)
        self.out_features = None
        if input_shape is not None:
            nz = self.sparse_shape(input_shape)[0]
            for m in (self.conv2, self.conv3, self.conv4, self.extra_conv):
                nz = strided_out_shape((nz, 1, 1), m.kernel, m.stride,
                                       m.padding)[0]
            self.out_features = 128 * nz

    def sparse_shape(self, input_shape):
        """(n_r, n_az, n_z) grid -> the (z, azimuth, range) sparse shape with
        the ``extra_sp_shape`` rows."""
        n_r, n_az, n_z = (int(s) for s in input_shape)
        ez, ey, ex = self.extra_sp_shape
        return (n_z + ez, n_az + ey, n_r + ex)

    def forward(self, voxel_features, coords, mask, input_shape):
        """voxel_features (B, N, C) f32, coords (B, N, 3) int32 (z, az, r)
        in any row order, mask (B, N) bool, input_shape the (n_r, n_az, n_z)
        grid -> BEV (B, n_az/8, n_r/8, nz' * 128) float32."""
        shape = self.sparse_shape(input_shape)
        n = voxel_features.shape[1]
        caps = [c or n for c in self.caps]
        feats, coords, mask = sort_rows(voxel_features.float(), coords,
                                        mask, shape)
        subm = (build_subm_neighbor_map_dense if self.index_method == "dense"
                else build_subm_neighbor_map)
        nmap0 = subm(coords, mask, shape)
        x = self.conv_input(feats, nmap0, mask)
        x = self.conv1_1(self.conv1_0(x, nmap0, mask), nmap0, mask)
        grid = SparseGrid(x, coords, mask, shape)
        for stage, cap in ((self.conv2, caps[1]), (self.conv3, caps[2]),
                           (self.conv4, caps[3]), (self.extra_conv, caps[3])):
            grid = stage(grid, cap)
        dense = sparse_to_dense(grid)               # (B, nz', ny, nx, 128)
        b, nz, ny, nx, c = dense.shape
        return dense.permute(0, 2, 3, 4, 1).reshape(b, ny, nx, c * nz)
