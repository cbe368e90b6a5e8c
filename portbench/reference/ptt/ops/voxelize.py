"""Dynamic voxelization on the points' device, a frozen copy of the
port's ``ops/voxelize.py`` (``dynamic_voxelize`` and ``DeviceVoxelizer``):
linear cell ids sorted, the capacity-bounded unique table (the lowest cell
ids kept), the rows of each cell summed in their stream order, then mean,
coords and mask. ``coords`` rows are the reversed point dims: (z, azimuth,
range) for the cylinder grids, (z, y, x) for the cuboid ones."""

import torch


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
