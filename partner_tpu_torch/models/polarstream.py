"""PolarStream, the azimuth-sector streaming detector (counterpart of
``partner_tpu/models/polarstream.py``).

A sweep is cut into ``n_sectors`` azimuth sectors. Each is rotated into
sector 0's frame and goes through the pillar encoder
(``dynamic_voxelize`` on the sector grid, ``DynamicPFNet``,
``pp_scatter``), a streaming neck (``RPNTECP`` / ``RPNBDCP``, or HAN's
``RPNWaymoLSTM`` and STROBE's ``RPNUber``, whose contexts pass from one
sector to the next) and the head. At inference each sector's boxes are
decoded, rotated back and go through a stateful NMS: the previous
sector's kept boxes near their shared edge are prepended as kept
suppressors.

Two sector shapes (``voxel_shape``):

- ``cylinder``: points [rho, phi, z, x, y, ...]; a sector is an azimuth
  slice of the polar grid (n_r, n_az / S), from ``range[1]``, turned by
  subtracting ``s x span`` from phi.
- ``cuboid`` (HAN and STROBE): points [x, y, z, ...]; a sector is the
  wedge [-pi + s span, -pi + (s + 1) span) of ``arctan2(y, x)``, span
  2 pi / S, turned onto the first wedge (``hypot``, ``arctan2 - s span``,
  then ``cos`` / ``sin`` back to x, y) and pillarized on
  :func:`cart_sector_spec`'s reduced cartesian grid.

- :class:`PolarStreamModule`: points -> {"sector_preds": [head maps per
  sector]}. With more than one sector the points are split into compact
  per-sector buffers by one stable sort (:meth:`_sector_buffers`); with
  one, the sweep is selected by an azimuth mask.
  With a ``seg_head`` (the det+seg configs' ``SingleConvHead``) each
  sector's canvas and neck map also give that sector's seg map.
- :class:`PolarStreamDetector`: ``loss`` (one ``center_head_loss`` per
  sector on that sector's targets, their mean; with a seg head each
  sector's seg loss against :func:`majority_cell_labels`) and
  ``predict`` (with a seg head ``point_seg_labels`` too).
- ``build_polarstream``, registered as ``PolarStream`` and
  ``PolarStreamBDCP``.

No hand kernel lies on this path: JAX wrote it in plain XLA, the port in
plain torch.
"""

import inspect
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import NEG_INF, rotated_nms, topk_lower_index_first
from ..ops.voxelize import dynamic_voxelize
from ..ops.warp import floor_mod
from .center_head import center_head_decode, center_head_loss
from .layers import constant
from .pillar import max_pillars_rule, pillar_module_kwargs, pp_scatter
from .registry import BBOX_HEADS, DETECTORS, NECKS, READERS, build_from_cfg
from .seg_head import (build_seg_head, majority_grid_labels,
                       neck_out_features, point_labels_from_grid, seg_loss,
                       seg_points)



def cart_sector_spec(full_range, grid, n_sectors):
    """(range, grid) of a cuboid sector (``polarstream.py:36-52``): every
    wedge is turned onto the first, from -pi, which lies in the lower
    left of the cartesian box; at 4 sectors and more both grid sides
    halve and ``range[3] = range[4] = 0``, at 2 the y side and
    ``range[4]``."""
    rng = list(full_range)
    g = list(grid)
    if n_sectors >= 4:
        g[0] //= 2
        g[1] //= 2
        rng[3] = 0.0
        rng[4] = 0.0
    elif n_sectors >= 2:
        g[1] //= 2
        rng[4] = 0.0
    return tuple(rng), tuple(g)


class PolarStreamModule(nn.Module):
    """points -> per sector (pillars -> PFN -> scatter -> streaming neck
    -> head), NHWC (``polarstream.py:55-287``)."""

    def __init__(self, reader_cfg, neck_cfg, head_cfg, grid_size, pc_range,
                 voxel_size, n_sectors=1, max_pillars=32768,
                 out_size_factor=8, seg_head_cfg=None,
                 voxel_shape="cylinder"):
        super().__init__()
        self.grid_size = tuple(grid_size)    # the full sweep (n_r|nx, ...)
        self.pc_range = tuple(pc_range)      # the full sweep
        self.voxel_size = tuple(voxel_size)
        self.voxel_shape = voxel_shape
        self.n_sectors = int(n_sectors)
        self.max_pillars = int(max_pillars)  # per sector and sample
        self.out_size_factor = out_size_factor
        rc = dict(reader_cfg)
        rc.setdefault("voxel_size", self.voxel_size)
        rc.setdefault("pc_range", self.sector_range())
        self.reader = build_from_cfg(rc, READERS)
        self.neck = build_from_cfg(dict(neck_cfg), NECKS)
        hc = dict(head_cfg)
        hc.setdefault("pc_range", self.sector_range())
        hc.setdefault("out_size_factor", out_size_factor)
        self.bbox_head = build_from_cfg(hc, BBOX_HEADS)
        self.seg_head = None
        if seg_head_cfg:
            self.seg_head = build_seg_head(
                seg_head_cfg, ("num_classes", "kernel", "weight", "type"),
                tuple(rc.get("num_filters", (64,)))[-1],
                neck_out_features(self.neck))

    def angle_span(self):
        """The azimuth extent of one sector, radians (a python float):
        2 pi / S for cuboid sectors."""
        if self.voxel_shape == "cuboid":
            return 2 * math.pi / self.n_sectors
        return (self.pc_range[4] - self.pc_range[1]) / self.n_sectors

    def sector_range(self):
        if self.voxel_shape == "cuboid":
            return cart_sector_spec(self.pc_range, self.grid_size,
                                    self.n_sectors)[0]
        r = list(self.pc_range)
        r[4] = r[1] + self.angle_span()
        return tuple(r)

    def sector_grid(self):
        if self.voxel_shape == "cuboid":
            return cart_sector_spec(self.pc_range, self.grid_size,
                                    self.n_sectors)[1]
        g = list(self.grid_size)
        g[1] = g[1] // self.n_sectors
        return tuple(g)

    def point_azimuth(self, points):
        """Each point's azimuth: ``arctan2(y, x)`` of a cuboid point, the
        phi column of a cylinder one."""
        if self.voxel_shape == "cuboid":
            return torch.atan2(points[..., 1], points[..., 0])
        return points[..., 1]

    def azimuth_origin(self):
        """Sector 0's lower azimuth edge: -pi for cuboid sectors, else
        ``range[1]`` (a python float)."""
        return -math.pi if self.voxel_shape == "cuboid" else self.pc_range[1]

    def sector_point_cap(self, n_points):
        """The rows of each sector's compact buffer: an even share plus
        60%, rounded up to 128 rows, at most ``n_points``."""
        cap = int(math.ceil(n_points / self.n_sectors * 1.6))
        return min(n_points, -(-cap // 128) * 128)

    def _sector_buffers(self, points, mask):
        """points (B, P, C), mask (B, P) -> per sector (points (B, cap, C),
        valid (B, cap)): the rows sorted stably by sector (masked rows
        last), and each sector's ``cap`` rows sliced from its offset in a
        buffer padded by ``cap`` zero rows. A sector's rows beyond ``cap``
        are dropped, as JAX drops them."""
        b, p, c = points.shape
        s_n = self.n_sectors
        sec = torch.clamp(torch.floor(
            (self.point_azimuth(points) - self.azimuth_origin())
            / self.angle_span()), 0, s_n - 1).long()
        sec = torch.where(mask, sec, s_n)
        order = torch.argsort(sec, dim=-1, stable=True)
        sorted_pts = torch.gather(points, 1, order[..., None].expand(-1, -1,
                                                                     c))
        counts = torch.zeros((b, s_n + 1), dtype=torch.long,
                             device=points.device).scatter_add_(
            1, sec, torch.ones_like(sec))
        offsets = F.pad(torch.cumsum(counts[:, :-1], dim=1), (1, 0))
        cap = self.sector_point_cap(p)
        idx = torch.arange(cap, device=points.device)
        sorted_pts = F.pad(sorted_pts, (0, 0, 0, cap))
        out = []
        for s in range(s_n):
            rows = offsets[:, s:s + 1] + idx
            pts_s = torch.gather(sorted_pts, 1,
                                 rows[..., None].expand(-1, -1, c))
            valid = idx < torch.clamp(counts[:, s:s + 1], max=cap)
            out.append((pts_s, valid))
        return out

    def _rotated(self, points, new_phi):
        """Points turned to azimuth ``new_phi``: cylinder [rho, new_phi, z,
        rho cos, rho sin, the columns after 5]; cuboid [rho cos, rho sin,
        z, the columns after 3], rho = hypot(x, y)."""
        if self.voxel_shape == "cuboid":
            rho = torch.hypot(points[..., 0], points[..., 1])
            cols = [(rho * torch.cos(new_phi))[..., None],
                    (rho * torch.sin(new_phi))[..., None], points[..., 2:]]
            return torch.cat(cols, dim=-1)
        rho = points[..., 0]
        cols = [rho[..., None], new_phi[..., None], points[..., 2:3],
                (rho * torch.cos(new_phi))[..., None],
                (rho * torch.sin(new_phi))[..., None]]
        if points.shape[-1] > 5:
            cols.append(points[..., 5:])
        return torch.cat(cols, dim=-1)

    def _rotate_points(self, points, valid, s):
        """A compact sector buffer re-referenced to sector 0's frame."""
        return self._rotated(points, self.point_azimuth(points)
                             - s * self.angle_span()), valid

    def _rotate_to_sector(self, points, mask, s):
        """Sector s of the whole buffer, selected by azimuth
        (``lo <= phi < lo + span``, lo = origin + s x span), re-referenced
        to sector 0."""
        span = self.angle_span()
        lo = self.azimuth_origin() + s * span
        phi = self.point_azimuth(points)
        sel = mask & (phi >= lo) & (phi < lo + span)
        return self._rotated(points, phi - s * span), sel

    def pillarize(self, points, mask):
        """``dynamic_voxelize`` on the sector grid (n_r, n_az / S, 1), the
        z extent one cell."""
        sr = self.sector_range()
        g = self.sector_grid()
        dev = points.device
        size = constant(self, "pillar_size", dev, lambda: torch.tensor(
            [self.voxel_size[0], self.voxel_size[1], sr[5] - sr[2]],
            dtype=torch.float32))
        pr = constant(self, "sector_range", dev, lambda: torch.tensor(
            sr, dtype=torch.float32))
        return dynamic_voxelize(points, mask, size, pr, (g[0], g[1], 1),
                                self.max_pillars, return_point_voxel=True,
                                features=False)

    def encode_sector(self, points, mask):
        """One sector's rotated points (B, P, C) and mask -> its canvas
        (B, n_az / S, n_r, F); the batch's pillars share one segment
        space, as in ``PointPillarsModule.encode_canvas``."""
        b, p, c = points.shape
        v = self.max_pillars
        vox = self.pillarize(points, mask)
        pv = vox["point_voxel"].long()
        offsets = torch.arange(b, device=points.device)[:, None] * v
        flat_seg = torch.where(pv < v, pv + offsets, b * v).reshape(b * p)
        feats = self.reader(points.reshape(b * p, c), mask.reshape(b * p),
                            flat_seg, vox["coords"].reshape(b * v, 3), b * v)
        return pp_scatter(feats.reshape(b, v, -1), vox["coords"],
                          vox["mask"], self.sector_grid())

    def sector_inputs(self, points, mask):
        """-> per sector (rotated points, validity): the compact buffers
        with more than one sector, the masked sweep with one."""
        if self.n_sectors > 1:
            return [self._rotate_points(pts, valid, s) for s, (pts, valid)
                    in enumerate(self._sector_buffers(points, mask))]
        return [self._rotate_to_sector(points, mask, 0)]

    def forward(self, example, generator=None):
        """example {"points": (B, P, C), "points_mask": (B, P)} ->
        {"sector_preds": [the head's maps of each sector]}, with a seg head
        also {"seg_preds": [each sector's (B, n_az / S, n_r, classes)]}
        over the sector's canvas and neck map. The neck's
        contexts pass from each sector to the next; in train mode every
        BatchNorm updates its running statistics once a sector, in sector
        order. ``generator`` is unused (no dropout)."""
        preds, segs, ctx = [], [], None
        for pts_s, sel in self.sector_inputs(example["points"],
                                             example["points_mask"]):
            canvas = self.encode_sector(pts_s, sel)
            x, ctx = self.neck(canvas, ctx)
            preds.append(self.bbox_head(x))
            if self.seg_head is not None:
                segs.append(self.seg_head(canvas, x)["seg_preds"])
        out = {"sector_preds": preds}
        if segs:
            out["seg_preds"] = segs
        return out

    def point_cells(self, points, mask, s):
        """Each point's cell of sector s's grid (``polarstream.py:
        289-300``): the whole buffer selected and turned as
        :meth:`_rotate_to_sector` does, the cell sizes the python float
        ``(hi - lo) / n`` rounded to float32, as JAX's weakly typed
        scalars are -> (az_idx, r_idx) int32 (B, P) and ok (B, P)."""
        g = self.sector_grid()
        sr = self.sector_range()
        pts_s, sel = self._rotate_to_sector(points, mask, s)
        r_idx = torch.floor((pts_s[..., 0] - sr[0])
                            / ((sr[3] - sr[0]) / g[0])).to(torch.int32)
        a_idx = torch.floor((pts_s[..., 1] - sr[1])
                            / ((sr[4] - sr[1]) / g[1])).to(torch.int32)
        ok = (sel & (r_idx >= 0) & (r_idx < g[0]) & (a_idx >= 0)
              & (a_idx < g[1]))
        return a_idx, r_idx, ok


def majority_cell_labels(a_idx, r_idx, ok, point_labels, grid, n_classes):
    """Each cell's majority label of a (n_az, n_r) sector grid
    (``polarstream.py:303-323``): :func:`majority_grid_labels` on cells
    (0, az, r), ``grid`` the sector grid (n_r, n_az, ...) -> (B, n_az,
    n_r) int32."""
    gi = torch.stack([torch.zeros_like(a_idx), a_idx, r_idx], -1)
    return majority_grid_labels(gi, ok, point_labels, (grid[1], grid[0]),
                                n_classes)


def rotate_boxes_to_global(boxes, shift):
    """Boxes (..., 7|9) [x, y, z, dx, dy, dz, (vx, vy,) yaw] in a sector's
    frame turned by +``shift`` radians about the origin
    (``polarstream.py:326-343``)."""
    t = torch.tensor(shift, dtype=torch.float32, device=boxes.device)
    c, s = torch.cos(t), torch.sin(t)
    out = [(boxes[..., 0] * c - boxes[..., 1] * s)[..., None],
           (boxes[..., 0] * s + boxes[..., 1] * c)[..., None],
           boxes[..., 2:6]]
    if boxes.shape[-1] >= 9:
        out += [(boxes[..., 6] * c - boxes[..., 7] * s)[..., None],
                (boxes[..., 6] * s + boxes[..., 7] * c)[..., None]]
    out.append(boxes[..., -1:] + shift)
    return torch.cat(out, dim=-1)


class PolarStreamDetector:
    """The sector loss and the streaming predict with stateful NMS
    (``polarstream.py:346-485``)."""

    input_kind = "points"

    def __init__(self, module, code_weights, weight, voxel_size=None,
                 test_cfg=None, carry_size=64, carry_margin=0.2,
                 seg_weight=2.0):
        self.module = module
        self.seg_weight = seg_weight
        self.code_weights = tuple(code_weights)
        self.weight = weight
        self.voxel_size = voxel_size
        self.test_cfg = dict(test_cfg or {})
        self.carry_size = carry_size      # boxes carried to the next NMS
        self.carry_margin = carry_margin  # radians from the shared edge

    @property
    def loss_keys(self):
        """The batch keys :meth:`loss` reads: the targets are per-task
        lists, each (B, S, ...) with more than one sector; with a seg head
        the points' labels too."""
        keys = ("points", "points_mask", "hm", "anno_box", "ind", "mask",
                "cat")
        if self.module.seg_head is not None:
            keys += ("points_label",)
        return keys

    def loss(self, example, generator=None):
        """One forward in the module's current mode and a
        ``center_head_loss`` per sector on ``t[:, s]`` of each target (the
        targets as they are with one sector) -> ``sector{s}_loss`` each and
        ``loss``, their sum divided by S. With a seg head and
        "points_label" (B, P) in the example, each sector's seg loss
        against its cells' majority labels: ``seg_loss`` is their sum
        divided by S, and ``loss`` takes the undivided sum through
        ``apply_seg_decay`` before the division (``polarstream.py:
        380-403``)."""
        preds = self.module(example, generator)
        n_sec = self.module.n_sectors
        total = 0.0
        logs = {}
        for s, sec_preds in enumerate(preds["sector_preds"]):
            sub = example
            if n_sec > 1:
                sub = dict(example)
                for k in ("hm", "anno_box", "ind", "mask", "cat"):
                    sub[k] = [t[:, s] for t in example[k]]
            ld = center_head_loss(sec_preds, sub, self.code_weights,
                                  self.weight)
            total = total + ld["loss"]
            logs[f"sector{s}_loss"] = ld["loss"]
        if "seg_preds" in preds and "points_label" in example:
            from .detectors import apply_seg_decay

            pts, pmask = seg_points(example)
            seg_total = 0.0
            for s, sp in enumerate(preds["seg_preds"]):
                a_idx, r_idx, ok = self.module.point_cells(pts, pmask, s)
                labels = majority_cell_labels(
                    a_idx, r_idx, ok, example["points_label"],
                    self.module.sector_grid(), sp.shape[-1])
                seg_total = seg_total + seg_loss(sp, labels,
                                                 weight=self.seg_weight)
            logs["seg_loss"] = seg_total / n_sec
            total = apply_seg_decay(total, seg_total, example)
        logs["loss"] = total / n_sec
        return logs

    def point_seg_labels(self, seg_preds, example):
        """Each point's class (1-based) at its cell of its sector's seg map,
        0 where it lies in no sector's grid, summed over the sectors (a
        point lies in one) -> (B, P) int64."""
        pts, pmask = seg_points(example)
        total = 0
        for s, sp in enumerate(seg_preds):
            a_idx, r_idx, ok = self.module.point_cells(pts, pmask, s)
            gi = torch.stack([torch.zeros_like(a_idx), a_idx, r_idx], -1)
            lab = point_labels_from_grid(sp, gi)
            total = total + torch.where(ok, lab, torch.zeros_like(lab))
        return total

    @torch.no_grad()
    def predict(self, example):
        """-> dict of (B, S x nms_post_max_size, ...) detections: each
        sector's kept boxes (7 columns: the decoded velocity is dropped,
        as in JAX), scores (0 where not kept), labels (-1 where not kept)
        and mask, the sectors in order. Puts the module in eval mode
        first. With a seg head ``point_seg_labels`` (B, P) too
        (:meth:`point_seg_labels`)."""
        self.module.eval()
        preds = self.module(example)
        out = self.decode(preds)
        if "seg_preds" in preds:
            out["point_seg_labels"] = self.point_seg_labels(
                preds["seg_preds"], example)
        return out

    @torch.no_grad()
    def decode(self, preds):
        """The module's sector maps -> :meth:`predict`'s detections: per
        sector the rectified decode, the boxes turned by ``s x span``, the
        score and range mask, the top ``nms_pre_max_size`` (ties to the
        lower index), then class-agnostic rotated NMS with the previous
        sector's carry prepended at scores + 1e4, the carried rows dropped
        and the kept rows first; the next carry is the top ``carry_size``
        kept boxes within ``carry_margin`` of this sector's leading edge
        (floor-mod azimuth distance)."""
        mod = self.module
        span = mod.angle_span()
        sr = mod.sector_range()
        tc = self.test_cfg
        nms_cfg = dict(tc.get("nms", {}))
        thr = tc.get("score_threshold", 0.1)
        pre = nms_cfg.get("nms_pre_max_size", 1024)
        post = nms_cfg.get("nms_post_max_size", 128)
        iou_thr = nms_cfg.get("nms_iou_threshold", 0.2)
        outs, carry = [], None
        for s, sec_preds in enumerate(preds["sector_preds"]):
            task = sec_preds["det_preds"][0]
            hw = (task["hm"].shape[1], task["hm"].shape[2])
            boxes, scores = center_head_decode(
                task, hw, self.voxel_size, sr, mod.out_size_factor,
                voxel_shape=mod.voxel_shape,
                rectify=tc.get("rectify", False))
            boxes = rotate_boxes_to_global(boxes, s * span)
            limit = tuple(tc.get("post_center_limit_range",
                                 [-80, -80, -10, 80, 80, 10]))
            pcr = constant(mod, f"limit{limit}", boxes.device,
                           lambda: torch.tensor(limit, dtype=torch.float32))
            if carry is None:
                ksize = min(self.carry_size, post)
                cb = boxes.new_zeros((boxes.shape[0], ksize, 7))
                cs = boxes.new_full((boxes.shape[0], ksize), NEG_INF)
            else:
                cb, cs = carry
            rows = [self._sector_nms(bx, sc, cbi, csi, pcr, thr, pre, post,
                                     iou_thr)
                    for bx, sc, cbi, csi in zip(boxes, scores, cb, cs)]
            out = {k: torch.stack([r[k] for r in rows])
                   for k in ("box3d_lidar", "scores", "mask", "label_preds")}
            outs.append(out)
            carry = self._next_carry(out,
                                     mod.azimuth_origin() + (s + 1) * span)
        return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}

    @staticmethod
    def _sector_nms(bx, sc, cb, cs, pcr, thr, pre, post, iou_thr):
        """One sample's sector: boxes (N, 9|7), class scores (N, C), the
        carry's boxes (K, 7) and scores (K,) -> its kept rows."""
        cls_score, label = sc.max(-1)
        m = ((cls_score > thr) & (bx[:, :3] >= pcr[:3]).all(-1)
             & (bx[:, :3] <= pcr[3:]).all(-1))
        masked = torch.where(m, cls_score, NEG_INF)
        top_s, top_i = topk_lower_index_first(masked, min(pre, bx.shape[0]))
        bx7 = torch.cat([bx[:, :6], bx[:, -1:]], -1)[top_i]
        n_carry = cb.shape[0]
        all_b = torch.cat([cb, bx7], 0)
        all_s = torch.cat([cs + 1e4, top_s], 0)
        keep, kmask = rotated_nms(all_b[:, [0, 1, 3, 4, 6]], all_s, iou_thr,
                                  post + n_carry)
        kmask = kmask & (keep >= n_carry)     # the carried rows go
        order = torch.argsort((~kmask).to(torch.uint8), stable=True)[:post]
        keep, kmask = keep[order], kmask[order]
        label = label[top_i][torch.clamp(keep - n_carry, min=0)]
        return {"box3d_lidar": all_b[keep],
                "scores": torch.where(kmask, all_s[keep], 0.0),
                "mask": kmask,
                "label_preds": torch.where(kmask, label, -1).to(torch.int32)}

    def _next_carry(self, out, edge):
        """A sector's kept rows -> (boxes (B, K, 7), scores (B, K)): the
        top K = min(carry_size, rows) by score of the kept boxes whose
        azimuth lies within ``carry_margin`` of ``edge`` (python float,
        radians), NEG_INF for the rest (invalid at the next NMS)."""
        kb, ks, km = out["box3d_lidar"], out["scores"], out["mask"]
        az = torch.atan2(kb[..., 1], kb[..., 0])
        daz = torch.abs(floor_mod(az - edge + math.pi,
                                  torch.tensor(2 * math.pi, device=az.device))
                        - math.pi)
        near = km & (daz < self.carry_margin)
        cscore = torch.where(near, ks, NEG_INF)
        top_c, idx_c = torch.sort(cscore, dim=-1, descending=True,
                                  stable=True)
        n_keep = min(self.carry_size, cscore.shape[-1])
        top_c, idx_c = top_c[:, :n_keep], idx_c[:, :n_keep]
        return torch.gather(kb, 1, idx_c[..., None].expand(-1, -1, 7)), top_c


def check_stream_neck(neck):
    """A sector loop hands its neck a context: a neck whose forward takes
    none (``RPN``, ``RPNHalo``) raises here, as JAX's module call would
    raise at its first sector."""
    name = dict(neck).get("type")
    cls = NECKS.get(name)
    if cls is not None and len(inspect.signature(cls.forward).parameters) < 3:
        raise ValueError(
            f"a sector-streaming detector passes its neck each sector's "
            f"context; neck {name} takes none (a context neck: "
            "RPNTECP, RPNBDCP, RPNUber, RPNWaymo / RPNWaymoLSTM)")


def stream_detector(module, bbox_head, seg_head, test_cfg):
    """``module`` in a :class:`PolarStreamDetector` with the config's loss
    weights (a seg head's ``weight`` 2.0 by default, as in JAX)."""
    return PolarStreamDetector(
        module, code_weights=bbox_head.get("code_weights", [1.0] * 10),
        weight=bbox_head.get("weight", 0.25),
        voxel_size=module.voxel_size, test_cfg=test_cfg,
        seg_weight=(seg_head or {}).get("weight", 2.0))


@DETECTORS.register_module(name="PolarStream")
@DETECTORS.register_module(name="PolarStreamBDCP")
def build_polarstream(reader, neck, bbox_head, backbone=None, seg_head=None,
                      pretrained=None, train_cfg=None, test_cfg=None,
                      max_pillars=None, part_head=None, *, device,
                      generator=None, use_block_kernel=False):
    """PolarStream factory (``polarstream.py:506-567``): the sector count
    from ``bbox_head["voxel_generator"]["nsectors"]``; ``max_pillars``,
    where the config does not set it, by :func:`max_pillars_rule`; the
    neck told ``nsectors``; the head config rewritten as
    ``build_voxelnet`` rewrites it; cylinder or cuboid sectors by the
    head's ``voxel_shape``. ``backbone`` (``DynamicPPScatter``) is not
    read: the module scatters its own canvas. Built on the meta device and
    materialized on ``device`` as the other factories do."""
    from .detectors import _materialize

    if use_block_kernel:
        raise ValueError("use_block_kernel is an option of the E2E head's "
                         "Swin blocks; PolarStream's head has none")
    check_stream_neck(neck)
    vg = bbox_head["voxel_generator"]
    n_sectors = vg.get("nsectors", 1)
    if max_pillars is None:
        max_pillars = max_pillars_rule(vg, n_sectors)
    kw = pillar_module_kwargs(reader, neck, bbox_head, max_pillars)
    kw["neck_cfg"].setdefault("nsectors", n_sectors)
    module = _materialize(device, generator, lambda: PolarStreamModule(
        n_sectors=n_sectors, voxel_shape=bbox_head.get("voxel_shape",
                                                       "cylinder"),
        seg_head_cfg=dict(seg_head) if seg_head else None, **kw))
    return stream_detector(module, bbox_head, seg_head, test_cfg)
