"""CenterPoint's multi-task head (counterpart of the Waymo half of
``partner_tpu/models/center_head.py``): ``CenterHead`` with one
``SepHead`` per task, and the pure functions over its maps, the loss
(FastFocal heatmap + L1 regression at the peaks), the decode and the
score / range mask with rotated NMS.

Maps are NHWC (B, H=azimuth, W=range, C), as in JAX. Submodules carry
flax's names (``Conv_0``, ``task{i}``, ``{head}_conv{j}``, ``{head}_out``),
so converted weights load by name. Not ported here, each waiting for the
slice that needs it (ROADMAP.md queue 1, off the main path):
``CenterHeadSingle`` / ``CenterHeadSinglePos`` with ``RSNorm``,
``RangeStratified`` and ``ConvGNStack``, and ``per_class_nms``
(``batched_rotated_nms``), for nuScenes and PolarStream; ``DCNSepHead``
(``dcn_head=True``, with ``ops/deform_conv.py``) and ``double_flip``
for the nuScenes DCN configs; the fused-branch ``SepHead`` option, a TPU
knob that lost there.
"""

import functools

import numpy as np
import torch
import torch.nn as nn

from ..core.geometry import bev_cell_centers
from ..losses.centernet import fast_focal_loss, reg_loss
from ..ops.nms import rotate_nms_pcdet
from .layers import Conv2d
from .registry import BBOX_HEADS

HEAD_CONV = 64  # SepHead's hidden width (``nn.Conv(64, ...)`` in JAX)


class SepHead(nn.Module):
    """Per-task separate conv heads: for each head, ``num_conv - 1`` 3x3
    convs with ReLU, then a 3x3 conv to its channels. Heads are built and
    returned in sorted name order; a head whose name holds ``hm`` starts
    its output bias at ``init_bias``, every other bias at zero."""

    def __init__(self, in_features, heads, init_bias=-2.19):
        super().__init__()
        self.heads = tuple(sorted(dict(heads).items()))
        for name, (classes, num_conv) in self.heads:
            cin = in_features
            for i in range(num_conv - 1):
                self.add_module(f"{name}_conv{i}",
                                Conv2d(cin, HEAD_CONV, 3, 1, 1))
                cin = HEAD_CONV
            self.add_module(f"{name}_out", Conv2d(
                cin, classes, 3, 1, 1,
                init_bias=init_bias if "hm" in name else None))

    def forward(self, x):
        out = {}
        for name, (_, num_conv) in self.heads:
            y = x
            for i in range(num_conv - 1):
                y = torch.relu(getattr(self, f"{name}_conv{i}")(y))
            out[name] = getattr(self, f"{name}_out")(y)
        return out


@BBOX_HEADS.register_module(name="CenterHead")
class CenterHead(nn.Module):
    """A shared 3x3 conv + ReLU, then one :class:`SepHead` per task.
    ``forward`` returns ``{"det_preds": [per-task dict of maps]}``."""

    def __init__(self, in_channels=512, tasks=(), common_heads=None,
                 share_conv_channel=64, num_hm_conv=2, init_bias=-2.19,
                 dcn_head=False, **kwargs):
        super().__init__()
        if dcn_head:
            raise NotImplementedError(
                "CenterHead(dcn_head=True): DCNSepHead is not ported "
                "(ROADMAP.md queue 1, off the main path: ops/deform_conv.py)")
        self.Conv_0 = Conv2d(in_channels, share_conv_channel, 3, 1, 1)
        self.num_tasks = len(tasks)
        for i, task in enumerate(tasks):
            heads = dict(common_heads or {})
            heads["hm"] = (len(task["class_names"]), num_hm_conv)
            self.add_module(f"task{i}", SepHead(share_conv_channel, heads,
                                                init_bias))

    def forward(self, x):
        """x: (B, n_az, n_r, in_channels) f32 -> {"det_preds": [...]}."""
        x = torch.relu(self.Conv_0(x))
        return {"det_preds": [getattr(self, f"task{i}")(x)
                              for i in range(self.num_tasks)]}


# ---------------------------------------------------------------------------
# loss / decode drivers (pure functions over head outputs)
# ---------------------------------------------------------------------------

# anno_box columns [x, y, z, dx, dy, dz, vx, vy, sin, cos] without velocity
_NO_VEL_COLUMNS = (0, 1, 2, 3, 4, 5, 8, 9)


def center_head_loss(preds_dicts, example, code_weights, weight):
    """FastFocal + weighted L1 regression per task.

    ``example`` carries per-task lists: ``hm`` (B, az, r, C) (or (B, C,
    az, r)), ``anno_box`` (B, M, 10), ``ind``/``mask``/``cat`` (B, M).
    Returns ``det_loss``, ``hm_loss``, ``loc_loss`` (lists of per-task
    scalars) and their total ``loss``."""
    rets = {"det_loss": [], "hm_loss": [], "loc_loss": []}
    total = 0.0
    for task_id, preds in enumerate(preds_dicts["det_preds"]):
        hm = torch.clamp(torch.sigmoid(preds["hm"]), 1e-4, 1 - 1e-4)
        target_hm = example["hm"][task_id]
        if target_hm.shape[1] != hm.shape[1]:   # (B, C, az, r) -> NHWC
            target_hm = target_hm.permute(0, 2, 3, 1)
        hm_l = fast_focal_loss(hm, target_hm, example["ind"][task_id],
                               example["mask"][task_id],
                               example["cat"][task_id])
        target_box = example["anno_box"][task_id]
        if "vel" in preds:
            anno = torch.cat([preds["reg"], preds["height"], preds["dim"],
                              preds["vel"], preds["rot"]], dim=-1)
        else:
            anno = torch.cat([preds["reg"], preds["height"], preds["dim"],
                              preds["rot"]], dim=-1)
            target_box = target_box[..., list(_NO_VEL_COLUMNS)]
        box_l = reg_loss(anno, example["mask"][task_id],
                         example["ind"][task_id], target_box)
        cw = torch.tensor(list(code_weights[: box_l.shape[0]]),
                          dtype=box_l.dtype).to(box_l.device)
        loc = (box_l * cw).sum()
        task_loss = hm_l + weight * loc
        total = total + task_loss
        rets["det_loss"].append(task_loss)
        rets["hm_loss"].append(hm_l)
        rets["loc_loss"].append(loc)
    rets["loss"] = total
    return rets


@functools.lru_cache(maxsize=32)
def _cell_corners(grid_hw, voxel_size, pc_range, out_size_factor,
                  voxel_shape, device):
    """(1, n, 2) float32 cartesian positions of the cells of an (h, w) map
    without the +0.5 offset (``bev_cell_centers(center_offset=0.0)``), and
    for cuboid grids the (1, n, 2) (row, column) index; built once per
    grid and device."""
    h, w = grid_hw
    cells = bev_cell_centers((w, h), voxel_size, pc_range, out_size_factor,
                             voxel_shape, center_offset=0.0)   # (r, az, 4)
    cart = np.ascontiguousarray(cells[..., :2].transpose(1, 0, 2))
    cart = torch.as_tensor(cart.reshape(1, h * w, 2), device=device)
    idx = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                   -1).reshape(1, h * w, 2)
    return cart, torch.as_tensor(idx, device=device)


def center_head_decode(preds, grid_hw, voxel_size, pc_range, out_size_factor,
                       voxel_shape="cylinder", rectify=False):
    """One task's maps -> (boxes (B, N, 7 or 9), scores (B, N, C)).

    ``grid_hw`` = (n_az, n_r) of the feature map. Boxes are [x, y, z, dx,
    dy, dz, (vx, vy,) yaw]: dims ``exp(clip(dim, -8, 8))``, yaw
    ``atan2(sin, cos)``; on a cylinder grid the cartesian ``reg`` offset is
    added to the cell corner, and ``rectify`` turns yaw and velocity by the
    cell's azimuth."""
    b, h, w, ncls = preds["hm"].shape
    n = h * w
    hm = torch.sigmoid(preds["hm"]).reshape(b, n, ncls)
    dims = torch.exp(torch.clamp(preds["dim"], -8.0, 8.0)).reshape(b, n, 3)
    rot = torch.atan2(preds["rot"][..., 0], preds["rot"][..., 1]).reshape(b, n)
    hei = preds["height"].reshape(b, n)
    reg = preds["reg"].reshape(b, n, 2)
    cart, idx = _cell_corners(
        (int(h), int(w)), tuple(float(v) for v in voxel_size),
        tuple(float(v) for v in pc_range), int(out_size_factor), voxel_shape,
        str(reg.device))
    if voxel_shape == "cylinder":
        xs = cart[..., 0] + reg[..., 0]
        ys = cart[..., 1] + reg[..., 1]
        azs = torch.atan2(ys, xs)
        if rectify:
            rot = rot + azs
    else:
        xs = ((idx[..., 1] + reg[..., 0]) * out_size_factor * voxel_size[0]
              + pc_range[0])
        ys = ((idx[..., 0] + reg[..., 1]) * out_size_factor * voxel_size[1]
              + pc_range[1])
    parts = [xs[..., None], ys[..., None], hei[..., None], dims]
    if "vel" in preds:
        vel = preds["vel"].reshape(b, n, 2)
        if voxel_shape == "cylinder" and rectify:
            vr = torch.linalg.norm(vel, dim=-1)
            va = torch.atan2(vel[..., 1], vel[..., 0]) + azs
            vel = torch.stack([vr * torch.cos(va), vr * torch.sin(va)], -1)
        parts.append(vel)
    parts.append(rot[..., None])
    return torch.cat(parts, dim=-1), hm


def center_head_post_process(boxes, scores, test_cfg, class_offset=0):
    """Score / range mask + rotated NMS -> fixed-size detections per
    sample: ``box3d_lidar``, ``scores``, ``label_preds`` (+
    ``class_offset``) and ``mask``, each (B, nms_post_max_size, ...).
    ``argmax`` ties go to the lower class."""
    if test_cfg.get("per_class_nms", False):
        raise NotImplementedError(
            "test_cfg per_class_nms: batched_rotated_nms is not ported "
            "(ROADMAP.md queue 1, off the main path: CenterHeadSingle and "
            "batched_rotated_nms)")
    nms_cfg = dict(test_cfg.get("nms", {}))
    pcr = test_cfg.get("post_center_limit_range",
                       [-80, -80, -10, 80, 80, 10])
    thr = test_cfg.get("score_threshold", 0.1)
    outs = []
    for bx, sc in zip(boxes, scores):
        cls_score, label = sc.max(-1)
        m = cls_score > thr
        for i in range(3):
            m &= (bx[:, i] >= pcr[i]) & (bx[:, i] <= pcr[3 + i])
        masked = torch.where(m, cls_score,
                             torch.full_like(cls_score, -float("inf")))
        bx7 = torch.cat([bx[:, :6], bx[:, -1:]], dim=-1)
        keep, kmask = rotate_nms_pcdet(
            bx7, masked, nms_cfg.get("nms_iou_threshold", 0.7),
            nms_cfg.get("nms_pre_max_size", 4096),
            nms_cfg.get("nms_post_max_size", 500))
        outs.append({
            "box3d_lidar": bx[keep],
            "scores": cls_score[keep],
            "label_preds": (label[keep] + class_offset).to(torch.int32),
            "mask": kmask & (masked[keep] > -float("inf")),
        })
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
