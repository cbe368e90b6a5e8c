"""IoU-regression losses and the corner loss (counterpart of
``partner_tpu/losses/iou_losses.py``), in plain torch with autograd.

The reference's ``IouRegLoss`` (IoU / GIoU / DIoU, ``loss_utils.py:
596-612``) and ``get_corner_loss_lidar`` (``loss_utils.py:212-236``), over
the exact rotated overlap of ``ops.rotated_iou.boxes_iou3d``:

  iou   the rotated 3D IoU
  giou  iou - (C - U) / C, C the enclosing box's volume, axis-aligned in
        the first box's yaw frame (so GIoU(b, b) = 1)
  diou  iou - d^2(centers) / c^2, c the diagonal of the world
        axis-aligned enclosing box

Every function is elementwise over aligned (..., 7) boxes [x, y, z, dx,
dy, dz, yaw].
"""

import math

import torch

from ..ops.rotated_iou import boxes_iou3d

_EPS = 1e-7


def corners_bev(boxes):
    """(..., 7) boxes -> (..., 4, 2) BEV corners."""
    cx, cy = boxes[..., 0], boxes[..., 1]
    dx, dy = boxes[..., 3] * 0.5, boxes[..., 4] * 0.5
    yaw = boxes[..., 6]
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    lx = torch.stack([dx, dx, -dx, -dx], -1)
    ly = torch.stack([-dy, dy, dy, -dy], -1)
    x = cx[..., None] + lx * c - ly * s
    y = cy[..., None] + lx * s + ly * c
    return torch.stack([x, y], -1)


def corners_3d(boxes):
    """(..., 7) boxes -> (..., 8, 3) corners (bottom 4, then top 4)."""
    bev = corners_bev(boxes)
    z0 = boxes[..., 2] - boxes[..., 5] * 0.5
    z1 = boxes[..., 2] + boxes[..., 5] * 0.5
    col = lambda z: z[..., None, None].expand(bev.shape[:-1] + (1,))
    return torch.cat([torch.cat([bev, col(z0)], -1),
                      torch.cat([bev, col(z1)], -1)], -2)


def _enclosing_aabb(boxes_a, boxes_b, frame="world"):
    """The axis-aligned box enclosing both boxes' corners, in the world
    frame or (``frame="a"``) in ``boxes_a``'s yaw frame -> (min, max),
    each (..., 3)."""
    allc = torch.cat([corners_3d(boxes_a), corners_3d(boxes_b)], dim=-2)
    if frame == "a":
        yaw = boxes_a[..., 6]
        c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
        x = allc[..., 0] * c + allc[..., 1] * s
        y = -allc[..., 0] * s + allc[..., 1] * c
        allc = torch.stack([x, y, allc[..., 2]], dim=-1)
    return allc.amin(dim=-2), allc.amax(dim=-2)


def bbox3d_overlaps_iou(boxes_a, boxes_b):
    return boxes_iou3d(boxes_a, boxes_b)


def bbox3d_overlaps_giou(boxes_a, boxes_b):
    iou = boxes_iou3d(boxes_a, boxes_b)
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    # the intersection volume, from the IoU identity
    inter = iou * (vol_a + vol_b) / (1.0 + iou)
    union = vol_a + vol_b - inter
    lo, hi = _enclosing_aabb(boxes_a, boxes_b, frame="a")
    c_vol = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    return iou - (c_vol - union) / torch.clamp(c_vol, min=_EPS)


def bbox3d_overlaps_diou(boxes_a, boxes_b):
    iou = boxes_iou3d(boxes_a, boxes_b)
    d2 = ((boxes_a[..., :3] - boxes_b[..., :3]) ** 2).sum(-1)
    lo, hi = _enclosing_aabb(boxes_a, boxes_b)
    c2 = ((hi - lo) ** 2).sum(-1)
    return iou - d2 / torch.clamp(c2, min=_EPS)


_IOU_FUNCS = {"IoU": bbox3d_overlaps_iou, "GIoU": bbox3d_overlaps_giou,
              "DIoU": bbox3d_overlaps_diou}


def iou_reg_loss(box_pred, box_gt, kind="DIoU", mask=None):
    """``1 - IoU_kind`` summed over the (masked) aligned pairs: the
    ``IouRegLoss`` forward (``loss_utils.py:608-611``)."""
    loss = 1.0 - _IOU_FUNCS[kind](box_pred, box_gt)
    if mask is not None:
        loss = loss * mask
    return loss.sum()


def corner_loss_lidar(pred_boxes, gt_boxes, beta=1.0):
    """The flip-invariant smooth-L1 corner distance, the mean over each
    box's 8 corners -> (...,)."""
    pc = corners_3d(pred_boxes)
    gc = corners_3d(gt_boxes)
    gcf = corners_3d(torch.cat([gt_boxes[..., :6],
                                gt_boxes[..., 6:7] + math.pi], -1))
    d = torch.minimum(torch.linalg.norm(pc - gc, dim=-1),
                      torch.linalg.norm(pc - gcf, dim=-1))
    absd = d.abs()
    sl1 = torch.where(absd < beta, 0.5 * d * d / beta, absd - 0.5 * beta)
    return sl1.mean(dim=-1)
