"""Rotated-rectangle intersection area by Green's theorem (counterpart of
``rect_intersection_area_green_pretrig``, ``_green_body`` and ``_clip_aa``
in ``partner_tpu/ops/rotated_iou.py``).

Area(A n B) = 1/2 of the contour integral of (x dy - y dx) over the
boundary of A n B, which splits into the edges of A clipped inside B plus
the edges of B clipped inside A; each straight piece P -> Q contributes
cross(P, Q). Pieces on the other box's boundary count half from each side,
which keeps identical and edge-sharing boxes exact. Boxes are
(..., 5) [x, y, dx, dy, yaw]; everything broadcasts.
"""

import torch


def _corners(h):
    """CCW corners (..., 4, 2) of the rect [-h, h]: the unit-square
    template (1, 1), (-1, 1), (-1, -1), (1, -1) times h, built without a
    host-to-device copy."""
    x, y = h[..., 0], h[..., 1]
    return torch.stack([torch.stack(c, -1)
                        for c in ((x, y), (-x, y), (-x, -y), (x, -y))], -2)


def _clip_aa(p0, p1, h, eps_par=1e-5, eps_c=1e-4):
    """Liang-Barsky clip of segments p0->p1 (..., E, 2) to the AA rect
    [-h, h] (h (..., 2)). Returns (t0, t1) in [0, 1] and a per-edge weight:
    1 interior, 0.5 for pieces on the rect boundary (within eps_c), 0
    outside."""
    a = p0
    d = p1 - p0
    hi = h[..., None, :].expand(a.shape)
    lo = -hi
    parallel = d.abs() < eps_par
    dd = torch.where(parallel, torch.ones_like(d), d)
    t_lo = (lo - a) / dd
    t_hi = (hi - a) / dd
    t_in = torch.minimum(t_lo, t_hi)
    t_out = torch.maximum(t_lo, t_hi)
    outside = (a < lo - eps_c) | (a > hi + eps_c)
    on_bound = parallel & ~outside & (
        ((a - lo).abs() <= eps_c) | ((a - hi).abs() <= eps_c))
    big = torch.full_like(t_in, 1e9)
    t_in = torch.where(parallel, torch.where(outside, big, -big), t_in)
    t_out = torch.where(parallel, torch.where(outside, -big, big), t_out)
    t0 = torch.clamp(t_in.amax(-1), 0.0, 1.0)
    t1 = torch.clamp(t_out.amin(-1), 0.0, 1.0)
    valid = t0 < t1
    weight = valid.to(t0.dtype) * torch.where(
        on_bound.any(-1), torch.full_like(t0, 0.5), torch.ones_like(t0))
    return t0, t1, weight


def rect_intersection_area_green_pretrig(box_a, box_b, trig_a, trig_b):
    """Intersection area with the per-box yaw trig precomputed
    (trig_* = (..., 2) [cos yaw, sin yaw]): the pair step carries no
    transcendentals, and for a == b the angle-difference sine is exactly
    0, so identical boxes stay exact."""
    ca, sa = trig_a[..., 0], trig_a[..., 1]
    cb_, sb_ = trig_b[..., 0], trig_b[..., 1]
    c = ca * cb_ + sa * sb_
    s = sa * cb_ - ca * sb_
    return _green_body(box_a, box_b, c, s, cb_, sb_)


def _rot(p, c, s):
    return torch.stack([p[..., 0] * c[..., None] - p[..., 1] * s[..., None],
                        p[..., 0] * s[..., None] + p[..., 1] * c[..., None]],
                       dim=-1)


def _green_body(box_a, box_b, c, s, cb_, sb_):
    dxy = box_a[..., :2] - box_b[..., :2]
    t_ab = torch.stack([dxy[..., 0] * cb_ + dxy[..., 1] * sb_,
                        -dxy[..., 0] * sb_ + dxy[..., 1] * cb_], dim=-1)
    ha = box_a[..., 2:4] * 0.5
    hb = box_b[..., 2:4] * 0.5
    ca_loc = _corners(ha)                            # A corners, A frame
    cb_loc = _corners(hb)                            # B corners, B frame
    ca_in_b = _rot(ca_loc, c, s) + t_ab[..., None, :]  # A corners, B frame
    t_ba = _rot((-t_ab)[..., None, :], c, -s)[..., 0, :]
    cb_in_a = _rot(cb_loc, c, -s) + t_ba[..., None, :]

    # A's edges clipped against B (B frame), B's against A (A frame); the
    # contributions are all evaluated in the common B frame
    a0, a1 = ca_in_b, torch.roll(ca_in_b, -1, dims=-2)
    ta0, ta1, wa = _clip_aa(a0, a1, hb)
    tb0, tb1, wb = _clip_aa(cb_in_a, torch.roll(cb_in_a, -1, dims=-2), ha)
    b0, b1 = cb_loc, torch.roll(cb_loc, -1, dims=-2)

    def contrib(p0, p1, t0, t1, w):
        q0 = p0 + t0[..., None] * (p1 - p0)
        q1 = p0 + t1[..., None] * (p1 - p0)
        cr = q0[..., 0] * q1[..., 1] - q0[..., 1] * q1[..., 0]
        return (w * cr).sum(-1)

    return 0.5 * (contrib(a0, a1, ta0, ta1, wa)
                  + contrib(b0, b1, tb0, tb1, wb)).abs()
