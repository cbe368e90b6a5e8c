"""Ego-motion warp of polar BEV maps (counterpart of
``partner_tpu/ops/warp.py``).

STROBE's V2 / V3 variants re-align the previous sweep's BEV map into the
current ego frame before they concatenate it: every cell centre of the
current (n_az, n_r) polar grid is moved by the 2D homogeneous
current -> previous transform, turned back into fractional polar grid
coordinates, and the previous map is sampled there bilinearly.

The sampling is JAX's ``map_coordinates(order=1, mode="constant")``
written out as four corner gathers: each corner's weight is JAX's
(``1 - (c - floor(c))`` below, ``c - floor(c)`` above), a corner outside
the map counts 0 (the corner, not the whole sample, as JAX masks it: a
source less than half a cell inside r0 or r1 reads one radial corner),
and the four products are summed in JAX's order. The azimuth coordinate
wraps with floor semantics (:func:`floor_mod`) and the map gets one
wrap row after its last, so a sample across the +-pi seam interpolates
between the last and the first row.
Cells whose source lies outside the radial range are zeroed after the
gather. ``grid_sample``'s normalized coordinates round differently, so
it is not used. No TPU kernel lies here: JAX wrote it in plain XLA, the
port in plain torch.
"""

import torch


def floor_mod(x, y):
    """``x % y`` with the sign of ``y``, as XLA computes ``jnp.remainder``:
    the exact ``fmod``, then ``y`` added where the signs differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _range(pc_range, device):
    return torch.as_tensor(pc_range, dtype=torch.float32, device=device)


def polar_cell_centers(n_az, n_r, pc_range, device=None):
    """(n_az, n_r) float32 grids of the cells' centre rho and phi over
    ``pc_range`` [r0, phi0, z0, r1, phi1, z1]."""
    pr = _range(pc_range, device)
    r = torch.arange(n_r, device=pr.device, dtype=torch.float32)
    a = torch.arange(n_az, device=pr.device, dtype=torch.float32)
    rho = pr[0] + (r + 0.5) * (pr[3] - pr[0]) / n_r
    phi = pr[1] + (a + 0.5) * (pr[4] - pr[1]) / n_az
    return rho[None].expand(n_az, n_r), phi[:, None].expand(n_az, n_r)


def ego_motion_warp_polar(features, transform, pc_range):
    """features (B, n_az, n_r, C) the previous sweep's map in its own
    frame, transform (B, 3, 3) current -> previous, ``pc_range`` (6,) ->
    the map resampled at the current grid's cells (B, n_az, n_r, C); a
    cell whose source lies outside [r0, r1] is 0. The azimuth axis always
    wraps (a whole sweep), as every caller of JAX's warp has it."""
    b, n_az, n_r, c = features.shape
    pr = _range(pc_range, features.device)
    rho, phi = polar_cell_centers(n_az, n_r, pr)
    x, y = rho * torch.cos(phi), rho * torch.sin(phi)
    tm = transform.to(torch.float32)[:, :, None, None, :]   # (B, 3, 1, 1, 3)
    px = tm[:, 0, ..., 0] * x + tm[:, 0, ..., 1] * y + tm[:, 0, ..., 2]
    py = tm[:, 1, ..., 0] * x + tm[:, 1, ..., 1] * y + tm[:, 1, ..., 2]
    src_r = torch.hypot(px, py)
    src_phi = torch.atan2(py, px)
    gr = (src_r - pr[0]) / (pr[3] - pr[0]) * n_r - 0.5
    gp = (src_phi - pr[1]) / (pr[4] - pr[1]) * n_az - 0.5
    gp = floor_mod(gp, torch.tensor(float(n_az), device=gp.device))
    f = torch.cat([features, features[:, :1]], dim=1)
    rows = n_az + 1
    a0, r0 = torch.floor(gp), torch.floor(gr)
    wa1, wr1 = gp - a0, gr - r0
    wa0, wr0 = 1 - wa1, 1 - wr1
    a0, r0 = a0.long(), r0.long()
    flat = f.reshape(b, rows * n_r, c)
    out = None
    for ai, wa in ((a0, wa0), (a0 + 1, wa1)):
        for ri, wr in ((r0, wr0), (r0 + 1, wr1)):
            ok = (ai >= 0) & (ai < rows) & (ri >= 0) & (ri < n_r)
            idx = (ai.clamp(0, rows - 1) * n_r + ri.clamp(0, n_r - 1))
            val = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(
                -1, -1, c)).reshape(b, n_az, n_r, c)
            term = (wa * wr)[..., None] * torch.where(ok[..., None], val, 0.0)
            out = term if out is None else out + term
    valid = (src_r >= pr[0]) & (src_r <= pr[3])
    return out * valid[..., None]


def make_bev_transform(dx, dy, dtheta):
    """(B,) ego-motion deltas -> (B, 3, 3) current -> previous transforms:
    the ego moved by (dx, dy) and turned by dtheta (in the previous
    frame), so a point p of the current frame lies at R(dtheta) p + t in
    the previous one."""
    c, s = torch.cos(dtheta), torch.sin(dtheta)
    zeros, ones = torch.zeros_like(dx), torch.ones_like(dx)
    return torch.stack([torch.stack([c, -s, dx], -1),
                        torch.stack([s, c, dy], -1),
                        torch.stack([zeros, zeros, ones], -1)], dim=-2)
