"""E2ESWVoteHead inference (counterpart of ``partner_tpu/models/e2e_head.py``).

Forward: vote offsets and vote objectness from the BEV map, a
SwinVoteTransformer conditioned on them, then cls / bbox / iou conv
branches (the unfused branches; the fused-branch option is not ported).
Decode: sigmoid scores x ((iou + 1) / 2) ** iou_factor, the box coder's
inverse, then a per-sample score / range mask and rotated NMS.
Maps are NHWC (B, H=azimuth, W=range, C).
"""

import numpy as np
import torch
import torch.nn as nn

from ..core.geometry import bev_cell_centers
from ..ops.nms import rotate_nms_pcdet
from ..utils.dtypes import resolve_compute_dtype
from .layers import BatchNorm, Conv2d, constant
from .registry import BBOX_HEADS
from .swin_vote import SwinVoteTransformer

# torch nn.BatchNorm2d default, which the reference E2E head uses
HEAD_BN_EPS = 1e-5


class ConvHead(nn.Module):
    def __init__(self, in_features, hidden, out, kernel=3, init_bias=None,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, hidden, kernel, 1, kernel // 2,
                             dtype=dtype)
        self.Conv_1 = Conv2d(hidden, out, kernel, 1, kernel // 2, dtype=dtype,
                             init_bias=init_bias)

    def forward(self, x):
        return self.Conv_1(torch.relu(self.Conv_0(x))).float()


class ConvBNHead(nn.Module):
    def __init__(self, in_features, hidden, out, kernel=3, init_bias=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(in_features, hidden, 3, 1, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(hidden, HEAD_BN_EPS)
        self.Conv_1 = Conv2d(hidden, out, kernel, 1, kernel // 2, dtype=dtype,
                             init_bias=init_bias)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x))).to(self.dtype)
        return self.Conv_1(x).float()


def head_offset_grid(grid_size, pc_range, out_size_factor,
                     voxel_shape="cylinder"):
    """(n_az, n_r, 2) float32 numpy cartesian cell-center grid of the head
    maps."""
    n_r = grid_size[0] // out_size_factor
    n_az = grid_size[1] // out_size_factor
    voxel_size = ((pc_range[3] - pc_range[0]) / grid_size[0],
                  (pc_range[4] - pc_range[1]) / grid_size[1])
    cells = bev_cell_centers((n_r, n_az), voxel_size, pc_range,
                             out_size_factor, voxel_shape, center_offset=0.5)
    return np.ascontiguousarray(cells[..., :2].transpose(1, 0, 2))


def flatten_head_preds(preds, offset_grid):
    """NHWC maps -> flattened (B, N, .) dicts; ``pred_boxes`` are in the
    coder's encoded space [abs_x, abs_y, z, log-dims, cos, sin]."""
    b, h, w, _ = preds["hm"].shape
    n = h * w
    reg_abs = preds["reg"] + offset_grid[None]
    centers_abs = preds["pred_centers"] + offset_grid[None]
    anno = torch.cat([reg_abs, preds["height"], preds["dim"], preds["rot"]],
                     dim=-1)
    out = {
        "pred_logits": preds["hm"].reshape(b, n, -1),
        "pred_boxes": anno.reshape(b, n, -1),
        "pred_centers": centers_abs.reshape(b, n, 2),
        "pred_vote_cls": preds["pred_vote_cls"].reshape(b, n, 1),
    }
    if "iou" in preds:
        out["pred_ious"] = preds["iou"].reshape(b, n, 1)
    return out


def decode_flat_preds(flat, coder, iou_factor=1.0, rectify=False):
    """-> (boxes (B, N, 7+), scores (B, N, ncls)) through the box coder;
    dims are floor-clamped at 1e-5 for the IoU/NMS downstream."""
    if rectify and not getattr(coder, "rectify", False):
        raise ValueError("test_cfg rectify=True requires a rectifying box "
                         "coder")
    scores = torch.sigmoid(flat["pred_logits"])
    if "pred_ious" in flat:
        iou = torch.clamp((flat["pred_ious"][..., 0] + 1.0) * 0.5, 0.0, 1.0)
        scores = scores * torch.pow(iou, iou_factor)[..., None]
    boxes = coder.decode(flat["pred_boxes"])
    dims = torch.clamp(boxes[..., 3:6], min=1e-5)
    return torch.cat([boxes[..., :3], dims, boxes[..., 6:]], dim=-1), scores


@BBOX_HEADS.register_module(name="E2ESWVoteHead")
class E2ESWVoteHead(nn.Module):
    def __init__(self, in_channels=512, num_classes=1, kernel_size=3,
                 window_size=7, sl_depth=2, num_heads=4, mlp_ratio=1.0,
                 iou_head=True, init_bias=-2.19, encode_angle_by_sincos=True,
                 grid_size=(1152, 2048, 40),
                 pc_range=(0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0),
                 out_size_factor=8, voxel_shape="cylinder",
                 compute_dtype="float32", **kwargs):
        super().__init__()
        dt = resolve_compute_dtype(compute_dtype)
        self.num_classes = num_classes
        self.offset_grid = head_offset_grid(grid_size, pc_range,
                                            out_size_factor, voxel_shape)
        half = in_channels // 2
        self.vote_head = ConvHead(in_channels, 64, 2, kernel_size, dtype=dt)
        self.vote_cls_head = ConvBNHead(in_channels, half, 1, kernel_size,
                                        dtype=dt)
        self.layer = SwinVoteTransformer(
            in_channels, embed_dim=half, depth=sl_depth, num_heads=num_heads,
            window_size=window_size, mlp_ratio=mlp_ratio,
            compute_dtype=compute_dtype)
        self.cls_head = ConvBNHead(half, half, num_classes, kernel_size,
                                   init_bias=init_bias, dtype=dt)
        code = 7 + (1 if encode_angle_by_sincos else 0)
        self.bbox_head = ConvHead(half, 64, code, kernel_size, dtype=dt)
        self.iou_head = (ConvHead(half, 64, 1, kernel_size, dtype=dt)
                         if iou_head else None)

    def offset_grid_on(self, device):
        return constant(self, "offset_grid", device, lambda: self.offset_grid)

    def forward(self, x):
        """x: (B, n_az, n_r, in_channels) BEV feature map -> dict of maps."""
        votes = self.vote_head(x)
        vote_cls = self.vote_cls_head(x)
        voted = torch.cat([votes, vote_cls], dim=-1)
        pos = self.offset_grid_on(x.device)[None].expand(
            x.shape[0], -1, -1, -1)
        feat = self.layer(x, pos, voted)
        out = {"pred_centers": votes, "pred_vote_cls": vote_cls,
               "hm": self.cls_head(feat)}
        boxes = self.bbox_head(feat)
        if self.iou_head is not None:
            out["iou"] = self.iou_head(feat)
        out["reg"] = boxes[..., 0:2]
        out["height"] = boxes[..., 2:3]
        out["dim"] = boxes[..., 3:6]
        out["rot"] = boxes[..., 6:8]
        return out

    @staticmethod
    def post_process(boxes, scores, score_threshold, post_center_range,
                     nms_iou_threshold, nms_pre, nms_post):
        """Decoded boxes/scores -> fixed-size NMS'd detections per sample:
        dict of (B, nms_post, ...) tensors plus a validity mask."""
        outs = []
        for bx, sc in zip(boxes, scores):
            cls_score, label = sc.max(-1)
            m = cls_score > score_threshold
            for i in range(3):
                m &= (bx[:, i] >= post_center_range[i]) & (
                    bx[:, i] <= post_center_range[3 + i])
            masked = torch.where(m, cls_score,
                                 torch.full_like(cls_score, -float("inf")))
            keep, kmask = rotate_nms_pcdet(bx, masked, nms_iou_threshold,
                                           nms_pre, nms_post)
            outs.append({
                "box3d_lidar": bx[keep],
                "scores": cls_score[keep],
                "label_preds": label[keep].to(torch.int32),
                "mask": kmask & (masked[keep] > -float("inf")),
            })
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
