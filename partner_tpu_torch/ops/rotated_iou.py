"""Rotated-rectangle intersection areas and the 3D IoU of the set loss
(counterpart of ``partner_tpu/ops/rotated_iou.py``).

Two exact algorithms, each where the JAX package uses it, so that results
round alike: Green's theorem for the NMS (``rect_intersection_area_green_
pretrig``, ``_green_body``, ``_clip_aa``) and the two-stage RoI targets
(``rect_intersection_area_green``), and Sutherland-Hodgman clipping for the
IoU target of ``loss_iou`` (``rect_intersection_area_sh``,
``boxes_iou3d``).

Green: Area(A n B) = 1/2 of the contour integral of (x dy - y dx) over the
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


def rect_intersection_area_green(box_a, box_b):
    """Intersection area with the trig computed here: the rotation
    between the boxes from the angle difference (so identical boxes map to
    exactly coincident rects), B's frame from B's yaw. The RoI targets
    use this form (``two_stage.proposal_targets``)."""
    dth = box_a[..., 4] - box_b[..., 4]
    return _green_body(box_a, box_b, torch.cos(dth), torch.sin(dth),
                       torch.cos(box_b[..., 4]), torch.sin(box_b[..., 4]))


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


# ------------------------------------------------------- Sutherland-Hodgman

_EPS = 1e-8


def _box_corners(boxes):
    """(..., 5) [x, y, dx, dy, yaw] -> (..., 4, 2) world corners, in the
    JAX package's order ((-,-), (-,+), (+,+), (+,-) halves, rotated CCW)."""
    hx, hy = boxes[..., 2] * 0.5, boxes[..., 3] * 0.5
    lx = torch.stack([-hx, -hx, hx, hx], -1)
    ly = torch.stack([-hy, hy, hy, -hy], -1)
    c, s = torch.cos(boxes[..., 4])[..., None], torch.sin(boxes[..., 4])[..., None]
    return torch.stack([lx * c - ly * s + boxes[..., 0:1],
                        lx * s + ly * c + boxes[..., 1:2]], dim=-1)


def _fill_next_defined(vals, defined):
    """Replace undefined slots (..., M, 2) with the next defined vertex,
    cyclically, in log2(M) jump passes."""
    m = vals.shape[-2]
    shift = 1
    while shift < m:
        nv = torch.roll(vals, -shift, dims=-2)
        nd = torch.roll(defined, -shift, dims=-1)
        vals = torch.where(defined[..., None], vals, nv)
        defined = defined | nd
        shift *= 2
    return vals


def _clip_halfplane(poly, axis, sign, bound):
    """One Sutherland-Hodgman clip, keeping sign * poly[axis] <= bound:
    (..., M, 2) vertices in order -> (..., 2M, 2) and a nonempty flag."""
    bound = bound[..., None]
    val = poly[..., axis] * sign
    inside = val <= bound
    nxt = torch.roll(poly, -1, dims=-2)
    val_n = torch.roll(val, -1, dims=-1)
    cross = inside != (val_n <= bound)
    den = val_n - val
    t = (bound - val) / torch.where(den.abs() < _EPS, torch.ones_like(den),
                                    den)
    t = torch.clamp(t, 0.0, 1.0)
    inter = poly + t[..., None] * (nxt - poly)
    out = torch.stack([poly, inter], dim=-2).reshape(
        poly.shape[:-2] + (2 * poly.shape[-2], 2))
    defined = torch.stack([inside, cross], dim=-1).reshape(
        inside.shape[:-1] + (2 * inside.shape[-1],))
    return _fill_next_defined(out, defined), defined.any(-1)


def rect_intersection_area_sh(box_a, box_b):
    """Exact rotated-rect intersection by Sutherland-Hodgman: A's corners
    in B's local frame, clipped by B's four half-planes; dropped slots take
    the next vertex, so zero-length edges add nothing to the shoelace sum.
    Boxes (..., 5), broadcastable."""
    rel = _box_corners(box_a) - box_b[..., None, :2]
    c = torch.cos(box_b[..., 4])[..., None]
    s = torch.sin(box_b[..., 4])[..., None]
    poly = torch.stack([rel[..., 0] * c + rel[..., 1] * s,
                        -rel[..., 0] * s + rel[..., 1] * c], dim=-1)
    hx, hy = box_b[..., 2] * 0.5, box_b[..., 3] * 0.5
    ok = torch.ones(poly.shape[:-2], dtype=torch.bool, device=poly.device)
    for axis, sign, bound in ((0, 1.0, hx), (0, -1.0, hx), (1, 1.0, hy),
                              (1, -1.0, hy)):
        poly, nonempty = _clip_halfplane(poly, axis, sign, bound)
        ok = ok & nonempty
    nxt = torch.roll(poly, -1, dims=-2)
    cross = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(ok, area, torch.zeros_like(area))


def _bev5(boxes7):
    """(..., 7) boxes -> (..., 5) BEV rectangles [x, y, dx, dy, yaw]."""
    return boxes7[..., [0, 1, 3, 4, 6]]


def boxes_iou3d(boxes_a, boxes_b):
    """Elementwise 3D IoU of aligned (..., 7) boxes [x, y, z, dx, dy, dz,
    yaw] (z the center) -> (...,)."""
    inter_bev = rect_intersection_area_sh(_bev5(boxes_a), _bev5(boxes_b))
    za1 = boxes_a[..., 2] - boxes_a[..., 5] * 0.5
    za2 = boxes_a[..., 2] + boxes_a[..., 5] * 0.5
    zb1 = boxes_b[..., 2] - boxes_b[..., 5] * 0.5
    zb2 = boxes_b[..., 2] + boxes_b[..., 5] * 0.5
    overlap_z = torch.clamp(torch.minimum(za2, zb2) - torch.maximum(za1, zb1),
                            min=0.0)
    inter = inter_bev * overlap_z
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return inter / torch.clamp(vol_a + vol_b - inter, min=_EPS)
