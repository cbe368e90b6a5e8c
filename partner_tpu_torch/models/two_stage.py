"""Two-stage CenterPoint: RoI refinement on the BEV map (counterpart of
``partner_tpu/models/two_stage.py``).

    first stage (a ``CenterPointDetector``: VoxelNet or PointPillars)
    -> proposals
    -> 5 sample points per box (center + 4 side midpoints)
    -> bilinear BEV features at each point (four-corner gather)
    -> the shared-MLP RoI head -> IoU confidence + box residuals.

Built from the Waymo two-stage configs (``TwoStageDetector`` wrapping a
``VoxelNet`` first stage, or a ``PointPillars`` one whose 468 x 468 x 384
neck map is sampled at stride 1 on the cuboid grid). ``TwoStageModule``
holds the first stage as
``first`` and the RoI head as ``roi_head`` (flax's names), so
``convert.flax_to_torch`` maps the JAX package's parameter tree as is.

The stage it adds is plain torch, as the JAX package's is plain XLA: the
sampling, the bilinear gather (``jax.scipy.ndimage.map_coordinates`` of
order 1 in constant mode, written out), the MLP and the rotated-IoU
targets. A VoxelNet first stage runs the stem and scatter-max kernels
as the one-stage detector does; a PointPillars one runs no hand kernel.

``freeze=True`` (the ``*_freeze`` configs) fine-tunes the RoI head alone,
as the reference det3d does, which is not what the JAX package does
(ROADMAP.md §3): the first stage stays in eval mode (running statistics,
a pillar encoder's ``MaskedBatchNorm`` too),
runs under ``torch.no_grad()``, and its parameters have
``requires_grad=False``, so the optimizer (built over the trainable
parameters) neither updates nor decays them. ``first_stage_cfg
["pretrained"]`` names the one-stage checkpoint the train CLI loads into
the first stage on a fresh run (``detector.pretrained``).
"""

import math
from contextlib import nullcontext

import torch
import torch.nn as nn

from ..ops.rotated_iou import rect_intersection_area_green
from ..parallel import dist
from .center_head import (center_head_decode, center_head_loss,
                          center_head_post_process)
from .detectors import CenterPointDetector
from .layers import Dense, LayerNorm, init_weights
from .registry import DETECTORS


def _cell_coord(u, lo, hi, n):
    """Position ``u`` in [lo, hi) -> fractional cell index (centers at
    integers), (u - lo) / (hi - lo) * n - 0.5 as XLA compiles the JAX
    package's expression: the constants folded into one float32 scale,
    and the scale's product and the - 0.5 rounded once (a fused
    multiply-add, written here as an exact float64 product and sum). At
    the stride-1 pillar grid's 468 cells a second rounding moves a
    coordinate by 3e-5 of a cell."""
    scale = float(torch.tensor(1.0) / torch.tensor(hi - lo) * n)
    return ((u - lo).double() * scale - 0.5).float()


def box_sample_points(boxes):
    """(..., 7+) boxes [x, y, z, dx, dy, ..., yaw] -> (..., 5, 3) sample
    points: the center and the 4 side midpoints, at the box's height."""
    cx, cy, cz = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    dx, dy = boxes[..., 3], boxes[..., 4]
    yaw = boxes[..., -1]
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(dx)
    # local side-midpoint offsets (+-dx/2, 0) and (0, +-dy/2)
    offs = torch.stack([z, z, dx / 2, z, -dx / 2, z, z, dy / 2, z, -dy / 2],
                       dim=-1).reshape(boxes.shape[:-1] + (5, 2))
    ox = offs[..., 0] * c[..., None] - offs[..., 1] * s[..., None]
    oy = offs[..., 0] * s[..., None] + offs[..., 1] * c[..., None]
    px = cx[..., None] + ox
    py = cy[..., None] + oy
    return torch.stack([px, py, cz[..., None].expand(px.shape)], dim=-1)


def bev_bilinear_sample(bev, pts_xy, pc_range, voxel_shape="cylinder"):
    """Bilinear BEV features at cartesian points.

    bev: (B, n_az, n_r, C) NHWC maps; pts_xy: (B, M, 2) -> (B, M, C). The
    points map to fractional cells
    (the polar grid on a ``cylinder``, else the cartesian one; cell
    centers at +0.5), and each of the four corner cells adds its value
    times its weight; a corner off the map adds 0, as
    ``map_coordinates(order=1, mode="constant", cval=0)`` does, in its
    order of summation."""
    b, n_az, n_r, c = bev.shape
    x, y = pts_xy[..., 0], pts_xy[..., 1]
    if voxel_shape == "cylinder":
        u, v = torch.hypot(x, y), torch.atan2(y, x)
    else:
        u, v = x, y
    a = _cell_coord(u, pc_range[0], pc_range[3], n_r)
    bb = _cell_coord(v, pc_range[1], pc_range[4], n_az)

    def corners(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        return ((idx, 1 - upper_w), (idx + 1, upper_w))

    flat = bev.reshape(b, n_az * n_r, c)
    out = 0
    for ib, wb in corners(bb):
        for ia, wa in corners(a):
            valid = (ib >= 0) & (ib < n_az) & (ia >= 0) & (ia < n_r)
            cell = (ib.clamp(0, n_az - 1) * n_r + ia.clamp(0, n_r - 1))
            val = torch.gather(flat, 1, cell[..., None].expand(-1, -1, c))
            w = (wb * wa)[..., None]
            val = torch.where(valid[..., None], val, torch.zeros_like(val))
            out = out + w * val
    return out


class RoIHead(nn.Module):
    """The shared MLP: per ``fc`` width Dense -> LayerNorm -> ReLU, then
    ``cls_out`` (1, the IoU logit) and ``reg_out`` (7, the residuals). No
    dropout: the JAX package ignores the config's ``DP_RATIO``."""

    def __init__(self, in_features, fc_channels=(256, 256), code_size=7):
        super().__init__()
        self.n_fc = len(fc_channels)
        cin = in_features
        for i, f in enumerate(fc_channels):
            self.add_module(f"Dense_{i}", Dense(cin, f))
            self.add_module(f"LayerNorm_{i}", LayerNorm(f))
            cin = f
        self.cls_out = Dense(cin, 1)
        self.reg_out = Dense(cin, code_size)

    def forward(self, x):
        """x (..., in_features) -> (IoU logits (...), residuals (..., 7))."""
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"LayerNorm_{i}")(
                getattr(self, f"Dense_{i}")(x)))
        return self.cls_out(x)[..., 0], self.reg_out(x)


class TwoStageModule(nn.Module):
    """The first stage's ``VoxelNetModule`` or ``PointPillarsModule``
    (``first``) and the
    ``RoIHead`` (``roi_head``). With ``freeze`` the first stage stays in
    eval mode through ``train()`` and runs without autograd."""

    def __init__(self, first, roi_head, num_point=5, voxel_shape="cylinder",
                 freeze=False):
        super().__init__()
        self.first = first
        self.roi_head = roi_head
        self.num_point = num_point
        self.voxel_shape = voxel_shape
        self.freeze = freeze

    def train(self, mode=True):
        super().train(mode)
        if self.freeze:
            self.first.eval()
        return self

    def forward(self, example, generator=None):
        """The first stage's head maps and its neck's BEV map
        (B, n_az / s, n_r / s, C), s its ``out_size_factor``."""
        with torch.no_grad() if self.freeze else nullcontext():
            return self.first(example, generator, return_bev=True)

    def refine(self, bev, boxes, scores):
        """bev (B, n_az, n_r, C); boxes (B, N, 7+); scores (B, N) ->
        (IoU logits (B, N), residuals (B, N, 7))."""
        pts = box_sample_points(boxes)                      # (B, N, 5, 3)
        b, n = boxes.shape[:2]
        feats = bev_bilinear_sample(
            bev, pts[..., :2].reshape(b, n * self.num_point, 2),
            self.first.pc_range, self.voxel_shape)
        feats = feats.reshape(b, n, self.num_point * bev.shape[-1])
        return self.roi_head(torch.cat([feats, scores[..., None]], dim=-1))


def _bev5(boxes):
    return torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 3],
                        boxes[..., 4], boxes[..., -1]], dim=-1)


def proposal_targets(proposals, gt_boxes, gt_mask):
    """RoI targets (the JAX package's jittable ProposalTargetLayer).

    proposals (..., N, 7), gt_boxes (..., M, 8) [box7, class], gt_mask
    (..., M) -> (iou_target (..., N), reg_target (..., N, 7), pos_mask
    (..., N)). Each proposal takes the gt of its best BEV IoU (the first
    on a tie); the IoU target is CenterPoint's clamp(2 iou - 0.5, 0, 1),
    positive above 0.55; the residuals are relative to the proposal."""
    gb = gt_boxes[..., :7]
    pb, g5 = _bev5(proposals), _bev5(gb)
    n, m = pb.shape[-2], g5.shape[-2]
    pair = pb.shape[:-2] + (n, m, 5)
    inter = rect_intersection_area_green(pb[..., :, None, :].expand(pair),
                                         g5[..., None, :, :].expand(pair))
    area_p = pb[..., 2] * pb[..., 3]
    area_g = g5[..., 2] * g5[..., 3]
    iou = inter / torch.clamp(area_p[..., :, None] + area_g[..., None, :]
                              - inter, min=1e-6)
    iou = torch.where(gt_mask[..., None, :], iou, torch.zeros_like(iou))
    best = torch.argmax(iou, dim=-1)
    best_iou = torch.amax(iou, dim=-1)
    g = torch.take_along_dim(gb, best[..., None], dim=-2)

    p = proposals
    d = torch.clamp(torch.hypot(p[..., 3], p[..., 4]), min=1e-3)
    tz_scale = torch.clamp(p[..., 5], min=1e-3)

    def log_ratio(i):
        return torch.log(torch.clamp(g[..., i], min=1e-3)
                         / torch.clamp(p[..., i], min=1e-3))

    dyaw = g[..., 6] - p[..., 6]
    dyaw = torch.remainder(dyaw + math.pi, 2 * math.pi) - math.pi
    reg = torch.stack([(g[..., 0] - p[..., 0]) / d,
                       (g[..., 1] - p[..., 1]) / d,
                       (g[..., 2] - p[..., 2]) / tz_scale,
                       log_ratio(3), log_ratio(4), log_ratio(5), dyaw], -1)
    iou_t = torch.clamp(2.0 * best_iou - 0.5, 0.0, 1.0)
    return iou_t, reg, best_iou > 0.55


def apply_residuals(proposals, reg):
    """The inverse of the residual encoding: (..., 7) proposals and
    residuals -> (..., 7) boxes."""
    p = proposals
    d = torch.clamp(torch.hypot(p[..., 3], p[..., 4]), min=1e-3)
    return torch.stack([
        p[..., 0] + reg[..., 0] * d,
        p[..., 1] + reg[..., 1] * d,
        p[..., 2] + reg[..., 2] * torch.clamp(p[..., 5], min=1e-3),
        p[..., 3] * torch.exp(reg[..., 3]),
        p[..., 4] * torch.exp(reg[..., 4]),
        p[..., 5] * torch.exp(reg[..., 5]),
        p[..., 6] + reg[..., 6]], dim=-1)


def _seven(boxes):
    """[x, y, z, dx, dy, dz, (vx, vy,) yaw] -> the 7 box columns."""
    return torch.cat([boxes[..., :6], boxes[..., -1:]], dim=-1)


class TwoStageDetector:
    """The two-stage driver: the first stage's loss (unless frozen) plus
    the RoI losses on its top decoded proposals; at inference the first
    stage's detections refined, scored by the geometric mean of the two
    stages' scores."""

    num_proposals_train = 128   # proposals a sample in the loss

    def __init__(self, module, first_driver, test_cfg=None, freeze=False,
                 pretrained=None):
        self.module = module
        self.first_driver = first_driver
        self.test_cfg = dict(test_cfg or {})
        self.freeze = freeze
        self.pretrained = pretrained
        self.input_kind = first_driver.input_kind
        # the batch keys :meth:`loss` reads; a frozen first stage has no
        # loss, so no center targets
        gt = ("global_box", "global_box_mask")
        self.loss_keys = (("points", "points_mask") + gt if freeze
                          else first_driver.loss_keys + gt)

    def decode_proposals(self, task, rectify=False):
        """One task's first-stage maps -> (boxes (B, N, 7 or 9), class
        scores (B, N, C)), decoded as the first stage decodes them."""
        fd, first = self.first_driver, self.module.first
        hm = task["hm"]
        return center_head_decode(
            task, (hm.shape[1], hm.shape[2]), fd.voxel_size, first.pc_range,
            first.out_size_factor, voxel_shape=fd.voxel_shape,
            rectify=rectify)

    def loss(self, example, generator=None):
        """One forward in the module's current mode (a frozen first stage
        in eval mode, without autograd) and the losses.

        example: the first stage's (points, and unless frozen its center
        targets) plus "global_box" (B, M, 8 or 10) [x, y, z, dx, dy, dz,
        (vx, vy,) yaw, class] and "global_box_mask" (B, M). Proposals are
        the top ``num_proposals_train`` decoded boxes by class score (no
        NMS; ties to the lower index). Returns the first stage's terms
        (none when frozen), ``roi_cls_loss`` (the squared error of the
        sigmoid IoU against its target), ``roi_reg_loss`` (L1 of the
        residuals over the positives) and ``loss``."""
        preds, bev = self.module(example, generator)
        fd = self.first_driver
        if self.freeze:
            ld = {"loss": 0.0}
        else:
            ld = center_head_loss(preds, example, fd.code_weights, fd.weight)
        boxes, scores = self.decode_proposals(preds["det_preds"][0])
        cls_score = scores.amax(-1)
        k = min(self.num_proposals_train, boxes.shape[1])
        top_s, top_i = torch.sort(cls_score, dim=1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :k].detach(), top_i[:, :k]
        props = _seven(torch.take_along_dim(boxes, top_i[..., None],
                                            dim=1)).detach()
        iou_pred, reg_pred = self.module.refine(bev, props, top_s)
        gt = example["global_box"]
        gt7c = torch.cat([gt[..., :6], gt[..., -2:]], dim=-1)
        iou_t, reg_t, pos = proposal_targets(props, gt7c,
                                             example["global_box_mask"])
        sq = (torch.sigmoid(iou_pred) - iou_t) ** 2
        # the global batch's mean and positives in a data-parallel step
        cls_loss = sq.sum() / (sq.numel() * dist.world_size())
        pos = pos.to(reg_pred.dtype)
        n_pos = torch.clamp(dist.global_sum(pos.sum()), min=1.0)
        reg_loss = ((reg_pred - reg_t).abs().sum(-1) * pos).sum() / n_pos
        ld["roi_cls_loss"] = cls_loss
        ld["roi_reg_loss"] = reg_loss
        ld["loss"] = ld["loss"] + cls_loss + reg_loss
        return ld

    @torch.no_grad()
    def predict(self, example):
        """-> dict of (B, nms_post, ...) detections + validity mask: the
        first stage's decoded and NMS'd boxes, refined by the RoI head's
        residuals (velocity columns kept), scored sqrt(score x IoU).
        Puts the module in eval mode first."""
        if self.test_cfg.get("double_flip"):
            raise NotImplementedError(
                "test_cfg double_flip: the two-stage detector has no "
                "double-flip branch (the JAX package's has none either); "
                "CenterPointDetector averages the flips")
        self.module.eval()
        preds, bev = self.module(example)
        boxes, scores = self.decode_proposals(
            preds["det_preds"][0], self.test_cfg.get("rectify", False))
        out = center_head_post_process(boxes, scores, self.test_cfg)
        props = out["box3d_lidar"]
        props7 = _seven(props)
        iou_pred, reg_pred = self.module.refine(bev, props7, out["scores"])
        refined = apply_residuals(props7, reg_pred)
        iou = torch.clamp(torch.sigmoid(iou_pred), 1e-4, 1.0)
        out["scores"] = torch.sqrt(torch.clamp(out["scores"], min=0.0)
                                   * iou) * out["mask"]
        if props.shape[-1] > 7:
            refined = torch.cat([refined[..., :6], props[..., 6:-1],
                                 refined[..., -1:]], dim=-1)
        out["box3d_lidar"] = refined
        return out


@DETECTORS.register_module(name="TwoStageDetector")
def build_two_stage(first_stage_cfg, roi_head=None, num_point=5,
                    freeze=False, train_cfg=None, test_cfg=None, *, device,
                    generator=None, use_block_kernel=False):
    """Two-stage factory (``TwoStageDetector`` config -> TwoStageDetector
    on ``device``): the first stage from ``first_stage_cfg`` (a VoxelNet
    or a PointPillars, one task: the JAX package refines task 0 only, so
    more tasks raise),
    then the RoI head over ``num_point`` x the BEV width + 1 inputs,
    widths from ``roi_head.fc`` or the reference's
    ``roi_head.model_cfg.SHARED_FC``, drawn from the same ``generator``
    (seed 0 when None). As in JAX, the config's ``second_stage_modules``
    and ``NMS_POST_MAXSIZE`` are not read: the samples follow the first
    stage's grid, and the NMS its ``test_cfg``. ``use_block_kernel``
    belongs to the E2E head."""
    from . import build_detector

    if use_block_kernel:
        raise ValueError("use_block_kernel is an option of the E2E head's "
                         "Swin blocks; the two-stage CenterPoint has none")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    first = build_detector(dict(first_stage_cfg), train_cfg, test_cfg,
                           device=device, generator=generator)
    if not isinstance(first, CenterPointDetector):
        raise TypeError("the two-stage detector wraps a CenterPoint-style "
                        "(VoxelNet or PointPillars) first stage")
    if first.module.bbox_head.num_tasks != 1:
        raise NotImplementedError(
            f"two-stage refinement of {first.module.bbox_head.num_tasks} "
            "tasks: the JAX package refines task 0 only, so the port takes "
            "one-task first stages")
    roi_cfg = dict(roi_head or {})
    fc = roi_cfg.get("fc")
    if fc is None:
        fc = dict(roi_cfg.get("model_cfg", {})).get("SHARED_FC", (256, 256))
    bev_width = first.module.bbox_head.Conv_0.weight.shape[1]
    with torch.device("meta"):
        head = RoIHead(num_point * bev_width + 1, tuple(fc))
    head = head.to_empty(device=device)
    init_weights(head, generator)
    module = TwoStageModule(first.module, head, num_point=num_point,
                            voxel_shape=first.voxel_shape,
                            freeze=freeze).eval()
    if freeze:
        first.module.requires_grad_(False)
    return TwoStageDetector(module, first, test_cfg=test_cfg, freeze=freeze,
                            pretrained=dict(first_stage_cfg).get(
                                "pretrained"))
