"""Segmentation heads, the seg loss and the grid label helpers
(counterpart of ``partner_tpu/models/seg_head.py``).

- :class:`SingleConvHead`: the neck's map resized (bilinear, half-pixel
  centres) to the canvas, concatenated after it, then a k x k conv to
  the class logits (PolarStream's det+seg configs).
- :class:`DeconvConvHead`: a transposed conv (kernel 2s, stride s, flax
  padding s) of the neck's map, resized to the canvas where it does not
  land on it, concatenated after the canvas, then a k x k conv. A 5-D
  canvas (B, D, H, W, C) folds its height into the channels and gives
  (B, D, H, W, classes); the configs reach the 4-D branch only (the
  backbones expose their BEV map as the canvas, as in JAX).
- The seg loss: :func:`cross_entropy_ignore` + :func:`lovasz_softmax_flat`
  (:func:`seg_loss`, labels 1-based, 0 ignored).
- The grid helpers: :func:`points_to_grid_cells`,
  :func:`majority_grid_labels`, :func:`point_labels_from_grid`, and the
  host-side :func:`panoptic_fuse`.

Maps are NHWC. ``jax.image.resize(..., "bilinear")`` antialiases when it
shrinks (its triangle kernel widened by the shrink factor, the weights
normalized): :func:`resize_bilinear` is ``F.interpolate`` with
``antialias=True`` where a side shrinks, which computes the same weights
(held against JAX at 506 -> 64 and 634 -> 80 by
``tests/test_torch_seg_head.py``). Submodules carry flax's names
(``Conv_0``, ``ConvTranspose_0``). No TPU kernel lies on this path: the
JAX package wrote it in plain XLA, the port in plain torch.
"""

import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.dist import global_cat, global_sum, world_size
from .layers import Conv2d, ConvTranspose2d
from .registry import SEG_HEADS, build_from_cfg


def neck_out_features(neck):
    """The width of a neck's output map: its deblocks' widths summed (an
    ``RPN``'s stages, or a stream neck's ``deblock{j}_bn``), else the last
    conv's."""
    if hasattr(neck, "stages"):
        ups = [getattr(neck, up[1]).weight.shape[0]
               for _, up in neck.stages if up]
        last_bn = neck.stages[-1][0][-1][1]
        return sum(ups) or getattr(neck, last_bn).weight.shape[0]
    return sum(m.weight.shape[0] for n, m in neck.named_children()
               if re.fullmatch(r"deblock\d+_bn", n))


def build_seg_head(cfg, keys, canvas_channels, feat_channels):
    """A seg head from the config's ``seg_head`` dict, its keys cut to
    ``keys`` as the JAX module cuts them, with the widths flax infers."""
    cfg = dict(cfg)
    name = cfg.get("type")
    if SEG_HEADS.get(name) is None:
        raise NotImplementedError(
            f"seg head {name} is not ported; models/seg_head.py builds "
            f"{sorted(SEG_HEADS._module_dict)}")
    return build_from_cfg({k: v for k, v in cfg.items() if k in keys},
                          SEG_HEADS, dict(canvas_channels=canvas_channels,
                                          feat_channels=feat_channels))


def resize_bilinear(x, hw):
    """NHWC ``x`` -> (B, hw[0], hw[1], C) as ``jax.image.resize(x, ...,
    "bilinear")`` (half-pixel centres; antialiased where a side
    shrinks)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    shrink = hw[0] < x.shape[1] or hw[1] < x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


def _conv(cin, num_classes, kernel):
    return Conv2d(cin, num_classes, kernel, 1, kernel // 2)


@SEG_HEADS.register_module(name="SingleConvHead")
class SingleConvHead(nn.Module):
    """``canvas_channels`` and ``feat_channels`` are the widths of the
    canvas and the neck's map (flax infers them; the builders pass
    them)."""

    def __init__(self, num_classes=16, kernel=1, weight=1.0,
                 canvas_channels=None, feat_channels=None):
        super().__init__()
        self.weight = weight
        self.Conv_0 = _conv(canvas_channels + feat_channels, num_classes,
                            kernel)

    def forward(self, canvas, feat):
        """canvas (B, H, W, C1) at full resolution, feat (B, h, w, C2) ->
        {"seg_preds": (B, H, W, num_classes)}."""
        up = resize_bilinear(feat, canvas.shape[1:3])
        return {"seg_preds": self.Conv_0(torch.cat([canvas, up], dim=-1))}


@SEG_HEADS.register_module(name="DeconvConvHead")
class DeconvConvHead(nn.Module):
    """The deconv has ``in_channels // up_scale`` outputs at ``height`` 1,
    else ``height``, as in JAX. ``canvas_depth`` D > 0 selects the 5-D
    branch (a (B, D, H, W, C1) canvas)."""

    def __init__(self, num_classes=16, kernel=1, in_channels=512,
                 up_scale=8, height=1, weight=1.0, canvas_channels=None,
                 feat_channels=None, canvas_depth=0):
        super().__init__()
        self.weight = weight
        self.num_classes = num_classes
        self.canvas_depth = canvas_depth
        deconv_ch = in_channels // up_scale if height == 1 else height
        s = up_scale
        self.ConvTranspose_0 = ConvTranspose2d(feat_channels, deconv_ch, s,
                                               kernel=2 * s, padding=s)
        d = max(canvas_depth, 1)
        self.Conv_0 = _conv(d * canvas_channels + deconv_ch,
                            num_classes * d, kernel)

    def forward(self, canvas, feat):
        """canvas (B, H, W, C1) or (B, D, H, W, C1), feat (B, h, w, C2) ->
        {"seg_preds": (B, [D,] H, W, num_classes)}."""
        up = self.ConvTranspose_0(feat)
        if canvas.dim() == 5:
            b, d, h, w, c1 = canvas.shape
            up = resize_bilinear(up, (h, w))
            flat = canvas.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c1)
            y = self.Conv_0(torch.cat([flat, up], dim=-1))
            y = y.reshape(b, h, w, d, self.num_classes).permute(0, 3, 1, 2, 4)
            return {"seg_preds": y}
        up = resize_bilinear(up, canvas.shape[1:3])
        return {"seg_preds": self.Conv_0(torch.cat([canvas, up], dim=-1))}


# ----------------------------------------------------------------- losses

def cross_entropy_ignore(logits, labels, ignore=-1):
    """Mean cross entropy over the rows whose label is not ``ignore``:
    logits (N, C), labels (N,) int. In a data-parallel step this rank's
    part of the global batch's mean (the valid rows counted over every
    rank)."""
    valid = labels != ignore
    safe = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum() / torch.clamp(global_sum(valid.sum()), min=1)


def lovasz_grad(gt_sorted):
    """The Lovasz extension's gradient over errors sorted in decreasing
    order, along dim 0 (gt_sorted (N,) or (N, C) float)."""
    gts = gt_sorted.sum(0)
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-9)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]], 0)


def lovasz_softmax_flat(probs, labels, valid):
    """Multi-class Lovasz-softmax: probs (N, C), labels (N,) int, valid
    (N,) bool. Per class the errors |fg - p| (0 on invalid rows) are sorted
    in decreasing order by a stable sort (JAX's ``argsort(-errors)``; the
    loss does not depend on the order of ties, a row's gradient does),
    dotted with :func:`lovasz_grad`, 0 for a class absent from the valid
    labels; the mean over the present classes."""
    c = probs.shape[1]
    cls = torch.arange(c, device=labels.device)
    fg = ((labels[:, None] == cls) & valid[:, None]).to(probs.dtype)
    errors = torch.abs(fg - probs) * valid[:, None]
    order = torch.argsort(-errors, dim=0, stable=True)
    e_sorted = torch.gather(errors, 0, order)
    fg_sorted = torch.gather(fg, 0, order)
    losses = (e_sorted * lovasz_grad(fg_sorted)).sum(0)
    present = fg.sum(0) > 0
    total = torch.where(present, losses, torch.zeros_like(losses)).sum()
    return total / torch.clamp(present.sum(), min=1)


def seg_loss(seg_preds, voxel_labels, ignore=-1, weight=1.0):
    """``weight`` x (cross entropy + Lovasz-softmax) over every cell:
    seg_preds (B, [D,] H, W, C), voxel_labels the same cells, int and
    1-based (0 = unlabelled, ignored).

    In a data-parallel step the Lovasz-softmax, which sorts every class's
    errors over the whole batch, runs on every rank's cells
    (``parallel.dist.global_cat``, in the global batch's order) and enters
    each rank's part divided by the world size; its gradient reaches each
    rank's own cells through the gather."""
    labels = voxel_labels.to(torch.int32).reshape(-1) - 1
    logits = seg_preds.reshape(-1, seg_preds.shape[-1])
    valid = labels >= 0
    ce = cross_entropy_ignore(logits, labels, ignore=-1)
    lv = lovasz_softmax_flat(global_cat(torch.softmax(logits, dim=-1)),
                             global_cat(labels), global_cat(valid))
    return weight * (ce + lv / world_size())


# ------------------------------------------------------------ grid helpers

def seg_points(example):
    """The points a batch's seg labels refer to: ``points`` and
    ``points_mask``, the last sweep of a (B, S, P, C) multi-sweep batch."""
    pts, mask = example["points"], example["points_mask"]
    if pts.dim() == 4:
        pts, mask = pts[:, -1], mask[:, -1]
    return pts, mask


def _grid_dims(out_shape):
    if len(out_shape) == 3:
        return tuple(int(s) for s in out_shape)
    return (1,) + tuple(int(s) for s in out_shape)


def points_to_grid_cells(points, mask, out_shape, pc_range,
                         voxel_shape="cylinder"):
    """Each point's cell of a (D, H, W) or (H, W) grid over ``pc_range``:
    rows (H) azimuth or y, columns (W) range or x, from the points' first
    three columns ([rho, phi, z, ...] or [x, y, z, ...] alike). The cell
    sizes are float32 ``(hi - lo) / n`` of the float32 range, as in JAX
    (a float64 size moves points on cell edges). -> (grid_ind (B, P, 3)
    int32 (z, row, col), z 0 for a 2-D grid; ok (B, P) bool)."""
    d, h, w = _grid_dims(out_shape)
    pr = torch.tensor(np.asarray(pc_range, np.float32), device=points.device)
    col = torch.floor((points[..., 0] - pr[0]) / ((pr[3] - pr[0]) / w))
    row = torch.floor((points[..., 1] - pr[1]) / ((pr[4] - pr[1]) / h))
    zi = torch.floor((points[..., 2] - pr[2]) / ((pr[5] - pr[2]) / d))
    gi = torch.stack([zi, row, col], -1).to(torch.int32)
    lim = torch.tensor([d, h, w], dtype=torch.int32, device=points.device)
    ok = mask & ((gi >= 0) & (gi < lim)).all(-1)
    return gi, ok


def majority_grid_labels(grid_ind, ok, point_labels, out_shape, n_classes):
    """Each cell's majority label of the points in it: grid_ind (B, P, 3)
    (z, row, col), ok (B, P), point_labels (B, P) int 1-based (0 =
    unlabelled). Integer counts per cell and class; class 0 never wins; a
    tie goes to the lower class (argmax's first); a cell with no labelled
    point gets 0. -> (B, [D,] H, W) int32."""
    d, h, w = _grid_dims(out_shape)
    b = grid_ind.shape[0]
    cells = d * h * w
    n1 = n_classes + 1
    gi = grid_ind.long()
    lab = point_labels.long()
    lin = (gi[..., 0] * h + gi[..., 1]) * w + gi[..., 2]
    lin = torch.where(ok & (lab > 0), lin, torch.full_like(lin, cells))
    idx = lin * n1 + torch.clamp(lab, 0, n_classes)
    idx = idx + torch.arange(b, device=idx.device)[:, None] * ((cells + 1)
                                                               * n1)
    counts = torch.zeros(b * (cells + 1) * n1, dtype=torch.int64,
                         device=idx.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx).reshape(-1))
    counts = counts.reshape(b, cells + 1, n1)[:, :cells].clone()
    counts[..., 0] = 0
    maj = torch.argmax(counts, dim=-1)
    maj = torch.where(counts.sum(-1) > 0, maj, torch.zeros_like(maj))
    shape = (b, d, h, w) if len(out_shape) == 3 else (b, h, w)
    return maj.to(torch.int32).reshape(shape)


def _jax_index(i, n):
    """An index as JAX's numpy indexing takes it: negative from the end,
    then clamped into [0, n)."""
    i = i.long()
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


def point_labels_from_grid(seg_preds, grid_ind):
    """Each point's predicted label (argmax + 1, 1-based) at its cell:
    seg_preds (B, D, H, W, C) or (B, H, W, C), grid_ind (B, P, 3) -> (B, P)
    int64. Indices off the grid are taken as JAX takes them (negative from
    the end, then clamped); callers mask those points."""
    cls = torch.argmax(seg_preds, dim=-1) + 1
    b = cls.shape[0]
    rows = torch.arange(b, device=cls.device)[:, None]
    if cls.dim() == 4:
        _, d, h, w = cls.shape
        return cls[rows, _jax_index(grid_ind[..., 0], d),
                   _jax_index(grid_ind[..., 1], h),
                   _jax_index(grid_ind[..., 2], w)]
    _, h, w = cls.shape
    return cls[rows, _jax_index(grid_ind[..., 1], h),
               _jax_index(grid_ind[..., 2], w)]


def panoptic_fuse(point_labels, points_xy, det_boxes, det_labels, det_scores,
                  det_mask, thing_classes, semantic2box, score_th=0.3):
    """Host-side (numpy) instance ids of the thing points: each point of a
    thing class takes the 1-based index, among the kept boxes, of the
    nearest box centre of its box label scoring above ``score_th``; other
    points 0."""
    inst = np.zeros(len(point_labels), dtype=np.int64)
    boxes = np.asarray(det_boxes)[np.asarray(det_mask)]
    labels = np.asarray(det_labels)[np.asarray(det_mask)]
    scores = np.asarray(det_scores)[np.asarray(det_mask)]
    for cls in thing_classes:
        pts_idx = np.flatnonzero(point_labels == cls)
        if not len(pts_idx):
            continue
        m = (labels == semantic2box.get(cls)) & (scores > score_th)
        if not m.any():
            continue
        centers = boxes[m][:, :2]
        ids = np.flatnonzero(m) + 1
        d = np.linalg.norm(points_xy[pts_idx][:, None, :] - centers[None],
                           axis=-1)
        inst[pts_idx] = ids[np.argmin(d, axis=1)]
    return inst
