"""Voxelization: on the host (numpy, first come first served) and on the
device (torch, a capacity-bounded unique table and mean features).

Counterpart of ``partner_tpu/ops/voxelize.py`` (which imports jax, so the
port keeps its own copy):

- :class:`VoxelGenerator` and :func:`points_to_voxel`: the hard voxelizer
  of the data path's ``hard`` mode. Voxels come in the order of their
  first point, each keeps its first ``max_points`` points in stream
  order, and voxels past ``max_voxels`` are dropped. ``generate`` runs the
  native library (``partner_tpu_torch/native``) where it is built and
  :func:`points_to_voxel`, the numpy body, elsewhere.
- :func:`dynamic_voxelize`: the serving tools' and ``dist_test --input
  voxels``' voxelizer, in plain torch on the points' device, as JAX wrote
  it in plain XLA (no Pallas kernel): linear cell ids sorted, the
  capacity-bounded unique table (the lowest cell ids kept), the rows of
  each cell summed in their stream order, then mean, coords and mask. It
  takes a batch where JAX ``vmap``s it. The sums are deterministic and,
  on the CPU, bit-equal to JAX's: the rows, stably sorted by cell, are
  added slot by slot in stream order, with no atomic adds, so a frame
  gives the same voxels on every run.
- :func:`points_to_bev`: the KITTI-style BEV map builder (numpy).

``coords`` rows are the reversed point dims: (z, azimuth, range) for the
cylinder grids (point dims rho, phi, z).
"""

import numpy as np
import torch


class VoxelGenerator:
    """Host hard voxelizer (VoxelGenerator + points_to_voxel)."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000):
        self.voxel_size = np.asarray(voxel_size, dtype=np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range,
                                            dtype=np.float32)
        self.max_num_points = max_num_points
        self.max_voxels = max_voxels
        grid = ((self.point_cloud_range[3:] - self.point_cloud_range[:3])
                / self.voxel_size)
        self.grid_size = np.round(grid).astype(np.int64)

    def generate(self, points, max_voxels=-1):
        if max_voxels == -1:
            max_voxels = self.max_voxels
        from .. import native

        if native.available() and points.dtype == np.float32:
            return native.points_to_voxel(
                points, self.voxel_size, self.point_cloud_range,
                self.max_num_points, max_voxels)
        return points_to_voxel(points, self.voxel_size,
                               self.point_cloud_range, self.max_num_points,
                               max_voxels)


def points_to_voxel(points, voxel_size, pc_range, max_points, max_voxels):
    """Vectorized FCFS hard voxelization.

    Returns (voxels (V, max_points, C), coords (V, 3) int32 reversed-dims,
    num_points_per_voxel (V,) int32).
    """
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    pc_range = np.asarray(pc_range, dtype=np.float32)
    grid_size = np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int64)

    coords_f = np.floor((points[:, :3] - pc_range[:3]) / voxel_size)
    valid = np.all((coords_f >= 0) & (coords_f < grid_size), axis=1)
    pts = points[valid]
    coords = coords_f[valid].astype(np.int64)

    # linear id in reversed-dim (z-major) order so voxel identity matches the
    # numba kernel's coor_to_voxelidx indexing
    lin = (coords[:, 2] * grid_size[1] + coords[:, 1]) * grid_size[0] + coords[:, 0]

    uniq, first_idx, inverse = np.unique(lin, return_index=True, return_inverse=True)
    # order voxels by first point occurrence (FCFS voxel ids)
    order = np.argsort(first_idx, kind="stable")
    rank_of_uniq = np.empty_like(order)
    rank_of_uniq[order] = np.arange(len(order))
    voxel_of_point = rank_of_uniq[inverse]

    keep_voxel = voxel_of_point < max_voxels
    # slot of each point within its voxel, in stream order
    sort_by_voxel = np.argsort(voxel_of_point, kind="stable")
    counts = np.bincount(voxel_of_point, minlength=len(uniq))
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_sorted = np.arange(len(voxel_of_point)) - group_start[voxel_of_point[sort_by_voxel]]
    slot = np.empty_like(slot_sorted)
    slot[sort_by_voxel] = slot_sorted

    keep = keep_voxel & (slot < max_points)
    n_vox = min(len(uniq), max_voxels)

    voxels = np.zeros((n_vox, max_points, points.shape[1]), dtype=points.dtype)
    voxels[voxel_of_point[keep], slot[keep]] = pts[keep]
    num_points = np.minimum(counts[:n_vox], max_points).astype(np.int32)

    coors = np.zeros((n_vox, 3), dtype=np.int32)
    first_point = first_idx[order[:n_vox]]
    coors[:, 0] = coords[first_point, 2]  # z
    coors[:, 1] = coords[first_point, 1]  # azimuth / y
    coors[:, 2] = coords[first_point, 0]  # range / x
    return voxels, coors, num_points


def dynamic_voxelize(points, points_mask, voxel_size, pc_range, grid_size,
                     max_voxels, return_point_voxel=False, features=True):
    """Dynamic voxelization with mean pooling, on the points' device.

    Args:
      points: (B, P, C) float32 padded point buffers; the first 3 columns
        are the grid coordinates (rho, phi, z for the cylinder layout).
      points_mask: (B, P) bool validity of each row.
      voxel_size, pc_range: (3,), (6,) float32 (tensors on the points'
        device, or sequences).
      grid_size: (nx, ny, nz) ints.
      max_voxels: capacity V; the V lowest linear cell ids are kept.
      features: False leaves the means out, and with them the per-slot
        sum loop and its host read (the pillar encoder pools its own).

    Returns a dict of
      features (with ``features``): (B, V, C) float32 mean of each
        voxel's rows;
      coords: (B, V, 3) int32 (z, y, x), 0 where masked;
      mask: (B, V) bool voxel validity (the occupied slots come first);
      num_points: (B, V) int32 member counts;
      point_voxel (with ``return_point_voxel``): (B, P) int32 slot of each
        row, V where the row is masked, out of range or over capacity.
    """
    nx, ny, nz = (int(g) for g in grid_size)
    b, p, c = points.shape
    v = int(max_voxels)
    dev = points.device
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    lo = torch.as_tensor(pc_range, dtype=torch.float32, device=dev)[:3]
    big = nx * ny * nz
    n_rows = p
    if p == 0:   # one masked row stands in for the empty buffer
        points = torch.zeros((b, 1, c), dtype=points.dtype, device=dev)
        points_mask = torch.zeros((b, 1), dtype=torch.bool, device=dev)
        p = 1
    # the float32 cell of each row, a true division as JAX computes it
    co = torch.floor((points[..., :3].float() - lo) / vs).long()
    lim = torch.tensor([nx, ny, nz], device=dev)
    valid = points_mask & ((co >= 0) & (co < lim)).all(-1)
    lin = (co[..., 2] * ny + co[..., 1]) * nx + co[..., 0]
    lin = torch.where(valid, lin, big)

    # stable: a cell's rows keep their stream order
    sorted_lin, order = torch.sort(lin, dim=1, stable=True)
    is_new = sorted_lin < big
    is_new[:, 1:] &= sorted_lin[:, 1:] != sorted_lin[:, :-1]
    rank = torch.cumsum(is_new, dim=1) - 1      # unique-cell rank of each row
    # each row's slot, V past the table: non-decreasing along the rows
    seg_sorted = torch.where((sorted_lin < big) & (rank < v), rank, v)
    slots = torch.arange(v + 1, device=dev).expand(b, v + 1).contiguous()
    bounds = torch.searchsorted(seg_sorted, slots)
    starts, counts = bounds[:, :v], bounds[:, 1:] - bounds[:, :v]
    vmask = counts > 0
    uniq = torch.where(
        vmask, torch.gather(sorted_lin, 1, starts.clamp(max=p - 1)), 0)

    z = uniq // (nx * ny)
    rem = uniq - z * (nx * ny)
    y = rem // nx
    x = rem - y * nx
    out = {
        "coords": torch.stack([z, y, x], dim=-1).to(torch.int32),
        "mask": vmask,
        "num_points": counts.to(torch.int32),
    }
    if features:
        # the rows of each slot summed in stream order, as JAX's
        # segment_sum adds them: the k-th row of every slot at once, k = 0
        # .. the most rows a slot holds (one host read); no atomics, so
        # every run sums alike
        rows = torch.gather(points.float(), 1,
                            order[..., None].expand(-1, -1, c))
        sums = torch.zeros((b, v, c), dtype=torch.float32, device=dev)
        for k in range(int(counts.max()) if counts.numel() else 0):
            row = torch.gather(rows, 1, (starts + k).clamp(max=p - 1)[
                ..., None].expand(-1, -1, c))
            sums += torch.where((k < counts)[..., None], row, 0.0)
        mean = sums / torch.clamp(counts, min=1)[..., None].float()
        out = {"features": torch.where(vmask[..., None], mean, 0.0), **out}
    if return_point_voxel:
        seg = torch.empty_like(seg_sorted).scatter_(1, order, seg_sorted)
        out["point_voxel"] = seg[:, :n_rows].to(torch.int32)
    return out


class DeviceVoxelizer:
    """:func:`dynamic_voxelize` at a config's ``voxel_generator`` (its
    grid, with the voxel size and range held on ``device``), giving the
    ``features`` input contract of the detectors.

        vox = DeviceVoxelizer(cfg["voxel_generator"], device, max_voxels)
        example = vox(points, points_mask)  # features, coords, voxel_mask
    """

    def __init__(self, voxel_generator, device, max_voxels):
        vg = dict(voxel_generator)
        self.voxel_size = torch.tensor(vg["voxel_size"], dtype=torch.float32,
                                       device=device)
        self.pc_range = torch.tensor(vg["range"], dtype=torch.float32,
                                     device=device)
        self.grid_size = tuple(
            int(round((vg["range"][3 + i] - vg["range"][i])
                      / vg["voxel_size"][i])) for i in range(3))
        self.max_voxels = int(max_voxels)

    def __call__(self, points, points_mask):
        v = dynamic_voxelize(points, points_mask, self.voxel_size,
                             self.pc_range, self.grid_size, self.max_voxels)
        return {"features": v["features"], "coords": v["coords"],
                "voxel_mask": v["mask"]}


def points_to_bev(points, voxel_size, pc_range, with_reflectivity=False,
                  max_voxels=40000):
    """KITTI-style BEV map builder — vectorized port of the reference's
    numba kernel (det3d/ops/point_cloud/bev_ops.py:8-117;
    a SECOND-lineage utility with no in-tree callers, kept for API parity).

    Returns (n_z + 1 [+1], H, W): per-height-slice normalized max height,
    a last channel of per-cell point counts, and (optionally) a
    reflectivity channel.

    Parity notes vs. the reference kernel:
    - ``max_voxels`` matches the reference's early ``break``
      (bev_ops.py:46-50): once the (max_voxels+1)-th DISTINCT occupied 3-D
      cell would be created, the kernel stops — all later points (even in
      already-open cells) are dropped. We truncate to the same point
      prefix.
    - reflectivity DEVIATES deliberately: the reference writes the
      intensity of whichever point last improved any z-slice's height max
      at (y, x) — an iteration-order-dependent value (bev_ops.py:55-62).
      We write the intensity of the column's overall highest point, which
      is deterministic and coincides with the reference whenever the
      column's global-highest point is processed last among its slice
      maxima.
    """
    voxel_size = np.asarray(voxel_size, dtype=points.dtype)
    pc_range = np.asarray(pc_range, dtype=points.dtype)
    grid = np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int32)
    nx, ny, nz = int(grid[0]), int(grid[1]), int(grid[2])

    coords = np.floor((points[:, :3] - pc_range[:3]) / voxel_size).astype(np.int64)
    ok = np.all((coords >= 0) & (coords < grid), axis=1)
    pts, coords = points[ok], coords[ok]

    lin3 = (coords[:, 2] * ny + coords[:, 1]) * nx + coords[:, 0]
    _, first_idx = np.unique(lin3, return_index=True)
    if len(first_idx) > max_voxels:
        cutoff = np.sort(first_idx)[max_voxels]
        pts, coords, lin3 = pts[:cutoff], coords[:cutoff], lin3[:cutoff]

    shape = [nz + 1 + int(with_reflectivity), ny, nx]
    bev = np.zeros(shape, dtype=points.dtype)

    height_lowers = np.linspace(pc_range[2], pc_range[5], nz, endpoint=False)
    hnorm = (pts[:, 2] - height_lowers[coords[:, 2]]) / voxel_size[2]

    flat = np.zeros(nz * ny * nx, dtype=points.dtype)
    np.maximum.at(flat, lin3, hnorm)
    bev[:nz] = flat.reshape(nz, ny, nx)

    lin2 = coords[:, 1] * nx + coords[:, 0]
    bev[-1] = np.bincount(lin2, minlength=ny * nx).reshape(ny, nx
                                                           ).astype(points.dtype)

    if with_reflectivity and pts.shape[1] > 3:
        # intensity of each column's highest point: sort so the max-z point
        # of every (y, x) column lands last, then scatter
        order = np.lexsort((pts[:, 2], lin2))
        refl = np.zeros(ny * nx, dtype=points.dtype)
        refl[lin2[order]] = pts[order, 3]
        bev[-2] = refl.reshape(ny, nx)
    return bev
