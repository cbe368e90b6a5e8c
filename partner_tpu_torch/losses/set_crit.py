"""SetCriterion: the matched losses of the E2E vote head (counterpart of
``partner_tpu/losses/set_crit.py:32-164``), over fixed-shape padded gt
buffers:

  loss_ce       sigmoid focal over all queries, one-hot targets at matched
                queries, / num_boxes
  loss_bbox     smooth-L1 (sigma) of the code-weighted coder deltas of
                matched pairs, / num_boxes
  loss_vote     smooth-L1 (sigma) of the predicted centers against the
                votemap centers where votemap[..., 0] != 0, / vote_num
  loss_vote_cls sigmoid focal of the vote objectness against the votemap
                gaussians, / vote_num
  loss_iou      smooth-L1 (beta 1) of the predicted IoU against
                2 * IoU3D(decode(pred), gt) - 1, / num_boxes

The assignment (the auction matcher) and the IoU target carry no
gradient; ``num_boxes`` and ``vote_num`` are floored at 1. The
``loss_iou_reg`` (DIoU) term is not ported: the flagship does not use it.
"""

import torch
import torch.nn.functional as F

from ..ops.rotated_iou import boxes_iou3d
from .centernet import sigmoid_focal_loss, smooth_l1
from .matcher import assign_auction


class SetCriterion:
    def __init__(self, box_coder, weight_dict, losses, sigma=3.0,
                 code_weights=(1.0,) * 8, gamma=2.0, alpha=0.25,
                 matcher_weights=None):
        if "loss_iou_reg" in losses:
            raise ValueError("loss_iou_reg (DIoU) is not ported")
        self.coder = box_coder
        self.weight_dict = dict(weight_dict)
        self.losses = list(losses)
        self.sigma = sigma
        self.code_weights = tuple(float(w) for w in code_weights)
        self.gamma = gamma
        self.alpha = alpha
        mw = matcher_weights or {"loss_ce": 0.25, "loss_bbox": 0.75}
        self.w_ce = mw["loss_ce"]
        self.w_bbox = mw["loss_bbox"]

    def __call__(self, preds, gt_boxes, gt_classes, gt_mask, votemap=None):
        """preds: pred_logits (B, N, ncls), pred_boxes (B, N, code) in the
        coder's space (absolute xy), pred_centers (B, N, 2), pred_vote_cls
        (B, N, 1), optional pred_ious (B, N, 1); gt_boxes (B, M, 7) raw,
        gt_classes (B, M) 0-based, gt_mask (B, M) bool; votemap
        (B, N, 4 + ncls). Returns the loss terms, ``loss`` (their weighted
        sum) and ``num_matched``."""
        logits = preds["pred_logits"]
        b, n, ncls = logits.shape
        cw = torch.tensor(self.code_weights, dtype=logits.dtype,
                          device=logits.device)
        gt_enc = self.coder.encode(gt_boxes)
        assigned = assign_auction(logits.detach(),
                                  preds["pred_boxes"].detach(), gt_classes,
                                  gt_enc, gt_mask, cw)
        matched = (assigned >= 0) & gt_mask
        safe_idx = torch.clamp(assigned, min=0)
        num_boxes = torch.clamp(gt_mask.sum().float(), min=1.0)
        out = {}

        pred_matched = torch.gather(
            preds["pred_boxes"], 1,
            safe_idx[..., None].expand(-1, -1, preds["pred_boxes"].shape[-1]))
        delta = self.coder.get_delta(gt_boxes, pred_matched) * cw
        lb = smooth_l1(delta, self.sigma) * matched[..., None]
        out["loss_bbox"] = lb.sum() / num_boxes

        one_hot = (F.one_hot(gt_classes.long(), ncls).to(logits.dtype)
                   * matched[..., None])
        target = torch.zeros_like(logits).scatter_add(
            1, safe_idx[..., None].expand(-1, -1, ncls), one_hot)
        # coincident matches could stack; clamp to a valid one-hot
        target = torch.clamp(target, 0.0, 1.0)
        out["loss_ce"] = (sigmoid_focal_loss(logits, target, self.gamma,
                                             self.alpha) / num_boxes)

        if votemap is not None and "pred_centers" in preds:
            votemask = votemap[..., 0] != 0
            vote_num = torch.clamp(votemask.sum().float(), min=1.0)
            vdelta = ((preds["pred_centers"] - votemap[..., :2])
                      * votemask[..., None])
            out["loss_vote"] = smooth_l1(vdelta, self.sigma).sum() / vote_num
            out["loss_vote_cls"] = sigmoid_focal_loss(
                preds["pred_vote_cls"], votemap[..., 4:], self.gamma,
                self.alpha) / vote_num

        if "pred_ious" in preds and "loss_iou" in self.losses:
            with torch.no_grad():
                dec = _safe_dims(self.coder.decode(pred_matched)[..., :7])
                t_iou = boxes_iou3d(dec, gt_boxes[..., :7])
                t_iou = torch.nan_to_num(t_iou) * 2.0 - 1.0
            p_iou = torch.gather(preds["pred_ious"][..., 0], 1, safe_idx)
            li = smooth_l1_torch(p_iou - t_iou) * matched
            out["loss_iou"] = li.sum() / num_boxes

        out["loss"] = sum(out[k] * self.weight_dict[k] for k in out
                          if k in self.weight_dict)
        out["num_matched"] = matched.sum()
        return out


def _safe_dims(boxes):
    """Floor the decoded dims at 1e-5 before the IoU."""
    dims = torch.clamp(boxes[..., 3:6], min=1e-5)
    return torch.cat([boxes[..., :3], dims, boxes[..., 6:]], dim=-1)


def smooth_l1_torch(x, beta=1.0):
    """torch's SmoothL1Loss element (beta 1), as the reference IOULoss."""
    absx = x.abs()
    return torch.where(absx < beta, 0.5 * x * x / beta, absx - 0.5 * beta)
