"""Capacity-bounded sparse 3D convolution (counterpart of
``partner_tpu/models/sparse.py``): the replacement of spconv's SubMConv3d
and SparseConv3d in the sparse backbone.

Active voxels live in fixed-capacity padded buffers, features (B, N, C),
coords (B, N, 3) int32 (z, y, x) and mask (B, N), kept sorted by linear
cell id per sample. A neighbour map gives, for each row of a resolution,
the row of each of its K kernel neighbours (sentinel N where there is
none); it is built once per resolution and shared by every conv there.
A conv is then a zero-padded neighbour gather and one (M, K*Cin) @
(K*Cin, Cout) product. Strided convs enumerate each input's candidate
output sites (at most 2 a dimension for kernel 3, stride 2), deduplicate
them, keep the ``cap`` lowest linear ids, and gather their receptive
fields.

Every function here works on a batch, per sample along the leading axis,
as ``jax.vmap`` runs the JAX functions. Their integer outputs are exactly
JAX's:

- ``//`` is floor division, as in JAX, through ``torch.div(...,
  rounding_mode="floor")``;
- every scatter with repeated indices writes equal values or lands in a
  sentinel slot that is sliced off or read only under a mask, so the
  writer a CUDA ``index_put_`` picks does not matter;
- ``torch.searchsorted`` takes ``side="left"`` on contiguous sorted rows.

Two index methods build the maps: ``"binary"`` (a binary search of the
sorted ids; needs the rows sorted by id, as the backbone sorts them) and
``"dense"`` (a grid-sized cell -> row table; any row order). Linear ids
are int64 inside (the flagship grid holds 96.7 million cells).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

from .layers import MaskedBatchNorm, _lecun_normal_


class SparseGrid(NamedTuple):
    """Fixed-capacity batched sparse tensor. coords are (z, y, x), sorted by
    linear id per sample; invalid rows have mask False."""

    features: torch.Tensor  # (B, N, C)
    coords: torch.Tensor    # (B, N, 3) int32
    mask: torch.Tensor      # (B, N) bool
    shape: Tuple[int, int, int]  # (nz, ny, nx)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _lin(coords, shape):
    c = coords.long()
    return (c[..., 0] * shape[1] + c[..., 1]) * shape[2] + c[..., 2]


def _lin_ids(coords, mask, shape):
    """(B, N) int64 linear ids, ``nz * ny * nx`` (big) at invalid rows."""
    big = int(shape[0]) * int(shape[1]) * int(shape[2])
    return torch.where(mask, _lin(coords, shape), big), big


def _triple(v):
    return tuple(int(x) for x in np.broadcast_to(np.asarray(v), (3,)))


def _subm_offsets(kernel, device):
    k = kernel // 2
    r = np.arange(-k, k + 1)
    off = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return torch.as_tensor(off, dtype=torch.int64, device=device)  # z-major


def _window_offsets(kernel, device):
    kz, ky, kx = _triple(kernel)
    off = np.stack(np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx),
                               indexing="ij"), -1).reshape(-1, 3)
    return torch.as_tensor(off, dtype=torch.int64, device=device)


def _neighbor_lin(base, base_mask, offsets, shape):
    """base (B, M, 3) + offsets (K, 3) -> ((B, M, K) linear ids, big where
    off the grid or the base row is invalid; that in-bounds mask)."""
    big = int(shape[0]) * int(shape[1]) * int(shape[2])
    nc = base.long()[:, :, None, :] + offsets[None, None]
    bounds = torch.tensor(shape, dtype=torch.int64, device=base.device)
    inb = ((nc >= 0) & (nc < bounds)).all(-1) & base_mask[:, :, None]
    nlin = (nc[..., 0] * shape[1] + nc[..., 1]) * shape[2] + nc[..., 2]
    return torch.where(inb, nlin, big), inb


def _search(lin, nlin, inb):
    """Rows of ``nlin`` (B, M, K) in the sorted ids ``lin`` (B, N), with
    sentinel N where absent."""
    b, n = lin.shape
    idx = torch.searchsorted(lin.contiguous(), nlin.reshape(b, -1),
                             side="left").reshape(nlin.shape)
    at = torch.gather(lin, 1, torch.clamp(idx, max=n - 1).reshape(b, -1))
    found = (idx < n) & (at.reshape(nlin.shape) == nlin) & inb
    return torch.where(found, idx, n).to(torch.int32)


def build_subm_neighbor_map(coords, mask, shape, kernel=3):
    """(B, N, K) neighbour rows with sentinel N, by binary search; coords
    (B, N, 3) sorted by linear id per sample, mask (B, N)."""
    lin, _ = _lin_ids(coords, mask, shape)
    nlin, inb = _neighbor_lin(coords, mask,
                              _subm_offsets(kernel, coords.device), shape)
    return _search(lin, nlin, inb)


def build_index_table(coords, mask, shape):
    """(B, total + 1) int32 tables mapping linear cell id -> row (sentinel N
    for empty cells; slot ``total`` absorbs the invalid rows' writes)."""
    b, n = mask.shape
    total = int(shape[0]) * int(shape[1]) * int(shape[2])
    lin, _ = _lin_ids(coords, mask, shape)
    table = torch.full((b, total + 1), n, dtype=torch.int32,
                       device=coords.device)
    rows = torch.arange(n, dtype=torch.int32, device=coords.device)
    table.scatter_(1, lin, rows.expand(b, n).contiguous())
    return table


def lookup_neighbors(table, shape, base_coords, base_mask, offsets, n_rows):
    """Rows of base_coords + offsets from index tables: base_coords (B, M,
    3), offsets (K, 3) -> (B, M, K) with sentinel n_rows."""
    nlin, inb = _neighbor_lin(base_coords, base_mask, offsets, shape)
    b = nlin.shape[0]
    idx = torch.gather(table, 1, nlin.reshape(b, -1)).reshape(nlin.shape)
    return torch.where(inb, idx, n_rows).to(torch.int32)


def build_subm_neighbor_map_dense(coords, mask, shape, kernel=3):
    table = build_index_table(coords, mask, shape)
    return lookup_neighbors(table, shape, coords, mask,
                            _subm_offsets(kernel, coords.device),
                            coords.shape[1])


def strided_out_shape(shape, kernel, stride, padding):
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(
        padding)
    return tuple((int(shape[d]) + 2 * padding[d] - kernel[d]) // stride[d] + 1
                 for d in range(3))


def _candidate_lin(coords, mask, shape, kernel, stride, padding):
    """Each input's candidate output sites of a strided conv -> ((B, 8N)
    linear ids in the output grid, ``total`` where invalid; out shape).

    A site j (per dim) is a candidate of input i iff ceil((i+p-k+1)/s) <=
    j <= floor((i+p)/s); for kernel 3, stride <= 2 at most 2 a dim."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(
        padding)
    out_shape = strided_out_shape(shape, kernel, stride, padding)
    cands, valids = [], []
    for d in range(3):
        i = coords[..., d].long()
        j_lo = -_floordiv(-(i + padding[d] - kernel[d] + 1), stride[d])
        j_hi = _floordiv(i + padding[d], stride[d])
        c0, c1 = j_lo, torch.minimum(j_lo + 1, j_hi)
        cand = torch.stack([c0, c1], -1)                       # (B, N, 2)
        valid = ((cand >= 0) & (cand < out_shape[d])
                 & (cand <= j_hi[..., None]))
        valid = valid & torch.stack([torch.ones_like(c0, dtype=torch.bool),
                                     c1 > c0], -1)
        cands.append(cand)
        valids.append(valid)
    cz = cands[0][..., :, None, None]
    cy = cands[1][..., None, :, None]
    cx = cands[2][..., None, None, :]
    valid = (valids[0][..., :, None, None] & valids[1][..., None, :, None]
             & valids[2][..., None, None, :] & mask[..., None, None, None])
    nzo, nyo, nxo = out_shape
    total = nzo * nyo * nxo
    lin = (cz * nyo + cy) * nxo + cx
    b = coords.shape[0]
    return torch.where(valid, lin, total).reshape(b, -1), out_shape


def _out_coords(uniq, out_shape):
    """(B, cap) linear ids (``total`` where empty) -> ((B, cap, 3) int32
    coords, 0 where empty; (B, cap) mask)."""
    nzo, nyo, nxo = out_shape
    out_mask = uniq < nzo * nyo * nxo
    z = _floordiv(uniq, nyo * nxo)
    rem = uniq - z * nyo * nxo
    y = _floordiv(rem, nxo)
    x = rem - y * nxo
    xyz = torch.stack([z, y, x], -1)
    return (torch.where(out_mask[..., None], xyz, 0).to(torch.int32),
            out_mask)


def downsample_coords(coords, mask, shape, kernel, stride, padding, cap):
    """Active output sites of a strided sparse conv, by sort + unique ->
    (out_coords (B, cap, 3) sorted, out_mask (B, cap)): the ``cap`` lowest
    linear ids."""
    lin, out_shape = _candidate_lin(coords, mask, shape, kernel, stride,
                                    padding)
    total = out_shape[0] * out_shape[1] * out_shape[2]
    b = lin.shape[0]
    s = torch.sort(lin, dim=1).values
    is_new = torch.cat([s[:, :1] < total,
                        (s[:, 1:] > s[:, :-1]) & (s[:, 1:] < total)], dim=1)
    rank = torch.cumsum(is_new, dim=1) - 1
    slot = torch.where(is_new & (rank < cap), rank, cap)
    uniq = torch.full((b, cap + 1), total, dtype=torch.int64,
                      device=lin.device)
    uniq.scatter_(1, slot, s)
    return _out_coords(uniq[:, :cap], out_shape)


def downsample_coords_dense(coords, mask, shape, kernel, stride, padding,
                            cap):
    """:func:`downsample_coords` through an output-resolution occupancy grid
    and one cumsum (no sort of the 8N candidates)."""
    lin, out_shape = _candidate_lin(coords, mask, shape, kernel, stride,
                                    padding)
    total = out_shape[0] * out_shape[1] * out_shape[2]
    b = lin.shape[0]
    occ = torch.zeros((b, total + 1), dtype=torch.int32, device=lin.device)
    occ.scatter_(1, lin, torch.ones_like(lin, dtype=torch.int32))
    cum = torch.cumsum(occ[:, :total], dim=1)                  # inclusive
    rank = torch.gather(cum, 1, torch.clamp(lin, max=total - 1)) - 1
    slot = torch.where((lin < total) & (rank < cap), rank, cap).long()
    uniq = torch.full((b, cap + 1), total, dtype=torch.int64,
                      device=lin.device)
    uniq.scatter_(1, slot, lin)
    return _out_coords(uniq[:, :cap], out_shape)


def build_strided_neighbor_map(out_coords, out_mask, out_shape, in_coords,
                               in_mask, in_shape, kernel, stride, padding):
    """(B, M, prod(kernel)) input rows of each output site's receptive
    field, sentinel N, by binary search of the sorted input ids."""
    base = (out_coords.long()
            * torch.tensor(_triple(stride), device=out_coords.device)
            - torch.tensor(_triple(padding), device=out_coords.device))
    nlin, inb = _neighbor_lin(base, out_mask,
                              _window_offsets(kernel, out_coords.device),
                              in_shape)
    lin, _ = _lin_ids(in_coords, in_mask, in_shape)
    return _search(lin, nlin, inb)


def build_strided_neighbor_map_dense(out_coords, out_mask, in_coords,
                                     in_mask, in_shape, kernel, stride,
                                     padding):
    """:func:`build_strided_neighbor_map` by the input's index table (the
    ``"dense"`` method; any row order)."""
    table = build_index_table(in_coords, in_mask, in_shape)
    base = (out_coords.long()
            * torch.tensor(_triple(stride), device=out_coords.device)
            - torch.tensor(_triple(padding), device=out_coords.device))
    return lookup_neighbors(table, in_shape, base, out_mask,
                            _window_offsets(kernel, out_coords.device),
                            in_coords.shape[1])


def gather_padded(features, nmap):
    """features (B, N, C), nmap (B, M, K) with sentinel N -> (B, M, K, C),
    zeros at the sentinel."""
    b, n, c = features.shape
    padded = torch.cat([features, features.new_zeros(b, 1, c)], dim=1)
    offs = torch.arange(b, device=nmap.device)[:, None, None] * (n + 1)
    idx = (nmap.long() + offs).reshape(-1)
    return padded.reshape(-1, c).index_select(0, idx).reshape(
        nmap.shape + (c,))


class SparseConv(nn.Module):
    """Gather-matmul sparse conv over a precomputed neighbour map (the map
    decides submanifold or strided). ``kernel`` keeps flax's flat
    (K*Cin, Cout) layout, kernel offset major, then input channel."""

    def __init__(self, in_features, features, num_kernel=27, use_bias=True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_kernel * in_features,
                                               features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def forward(self, feats, nmap):
        """feats (B, N, Cin), nmap (B, M, K) -> (B, M, Cout)."""
        g = gather_padded(feats, nmap)
        y = g.reshape(g.shape[0], g.shape[1], -1) @ self.kernel
        return y if self.bias is None else y + self.bias

    def init_extra(self, generator):
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            self.bias.fill_(0.0)


class SubMBlock(nn.Module):
    """SubMConv3d (no bias) + BN + ReLU (the conv_input pattern)."""

    def __init__(self, in_features, features):
        super().__init__()
        self.SparseConv_0 = SparseConv(in_features, features, use_bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def forward(self, feats, nmap, mask):
        return torch.relu(self.MaskedBatchNorm_0(
            self.SparseConv_0(feats, nmap), mask))


class SparseBasicBlock(nn.Module):
    """Two submanifold 3x3x3 convs (with bias) with a residual."""

    def __init__(self, features):
        super().__init__()
        self.SparseConv_0 = SparseConv(features, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        self.SparseConv_1 = SparseConv(features, features)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features)

    def forward(self, feats, nmap, mask):
        y = torch.relu(self.MaskedBatchNorm_0(self.SparseConv_0(feats, nmap),
                                              mask))
        y = self.MaskedBatchNorm_1(self.SparseConv_1(y, nmap), mask)
        return torch.relu(y + feats) * mask[..., None].to(y.dtype)


class SparseDownBlock(nn.Module):
    """SparseConv3d(stride) (no bias) + BN + ReLU, then ``num_res``
    :class:`SparseBasicBlock`\\ s at the output resolution (one conv2 /
    conv3 / conv4 stage, or ``extra_conv`` with ``num_res=0``)."""

    def __init__(self, in_features, features, kernel=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1), num_res=2,
                 index_method="dense"):
        super().__init__()
        if index_method not in ("binary", "dense"):
            raise ValueError(f"index_method {index_method!r}: 'binary' or "
                             "'dense'")
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.num_res = num_res
        self.index_method = index_method
        k = int(np.prod(_triple(kernel)))
        self.SparseConv_0 = SparseConv(in_features, features, num_kernel=k,
                                       use_bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        for i in range(num_res):
            setattr(self, f"SparseBasicBlock_{i}", SparseBasicBlock(features))

    def forward(self, grid, cap=0):
        """grid -> the output :class:`SparseGrid` of ``cap`` rows (0: the
        input's N), the sites of lowest linear id."""
        cap = cap or grid.features.shape[1]
        out_shape = strided_out_shape(grid.shape, self.kernel, self.stride,
                                      self.padding)
        geom = (self.kernel, self.stride, self.padding)
        if self.index_method == "dense":
            out_coords, out_mask = downsample_coords_dense(
                grid.coords, grid.mask, grid.shape, *geom, cap)
            nmap = build_strided_neighbor_map_dense(
                out_coords, out_mask, grid.coords, grid.mask, grid.shape,
                *geom)
        else:
            out_coords, out_mask = downsample_coords(
                grid.coords, grid.mask, grid.shape, *geom, cap)
            nmap = build_strided_neighbor_map(
                out_coords, out_mask, out_shape, grid.coords, grid.mask,
                grid.shape, *geom)
        y = torch.relu(self.MaskedBatchNorm_0(
            self.SparseConv_0(grid.features, nmap), out_mask))
        if self.num_res:
            subm = (build_subm_neighbor_map_dense
                    if self.index_method == "dense"
                    else build_subm_neighbor_map)
            sub_nmap = subm(out_coords, out_mask, out_shape)
            for i in range(self.num_res):
                y = getattr(self, f"SparseBasicBlock_{i}")(y, sub_nmap,
                                                           out_mask)
        return SparseGrid(y, out_coords, out_mask, out_shape)


def sparse_to_dense(grid):
    """Scatter (B, N, C) into a dense (B, nz, ny, nx, C) tensor."""
    nz, ny, nx = grid.shape
    b, n, c = grid.features.shape
    total = nz * ny * nx
    lin, _ = _lin_ids(grid.coords, grid.mask, grid.shape)
    lin = lin + torch.arange(b, device=lin.device)[:, None] * (total + 1)
    feats = torch.where(grid.mask[..., None], grid.features,
                        torch.zeros((), dtype=grid.features.dtype,
                                    device=grid.features.device))
    dense = grid.features.new_zeros(b * (total + 1), c)
    dense = dense.index_put((lin.reshape(-1),), feats.reshape(-1, c))
    return dense.reshape(b, total + 1, c)[:, :total].reshape(b, nz, ny, nx,
                                                               c)
