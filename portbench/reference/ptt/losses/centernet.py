"""CenterNet losses (counterpart of ``partner_tpu/losses/centernet.py``):
the CenterPoint head's ``fast_focal_loss`` and ``reg_loss`` over NHWC maps
flattened to (B, H*W, C) with the index ``ind = az * n_r + r`` of the
host target assigner, and the element losses of the E2E set criterion.
In a data-parallel step the normalizers (``num_pos``, the regression's
mask sum) are the global batch's (``parallel.dist.global_sum``), each
clamp and epsilon applied to the global count: each rank's loss is its
part of the global batch's."""

import torch

from ..parallel.dist import global_sum


def _gather_feat(feat, ind):
    """feat (B, HW, C), ind (B, M) -> (B, M, C)."""
    return torch.gather(feat, 1, ind.long()[..., None].expand(
        -1, -1, feat.shape[-1]))


def fast_focal_loss(out, target, ind, mask, cat):
    """CornerNet focal loss.

    out/target: (B, H, W, C) with ``out`` already sigmoid-clamped;
    ind/mask/cat: (B, M). With no positive the loss is the negative term
    alone, chosen on the device (no host read)."""
    b = out.shape[0]
    mask = mask.to(out.dtype)
    gt_weight = torch.pow(1 - target, 4)
    neg_loss = (torch.log(1 - out) * torch.pow(out, 2) * gt_weight).sum()
    flat = out.reshape(b, -1, out.shape[-1])
    pos_pred = torch.gather(_gather_feat(flat, ind), 2,
                            cat.long()[..., None])[..., 0]       # (B, M)
    num_pos = global_sum(mask.sum())
    pos_loss = (torch.log(pos_pred) * torch.pow(1 - pos_pred, 2)
                * mask).sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def reg_loss(output, mask, ind, target):
    """L1 regression at the peak cells; returns the per-dim loss (D,).

    output (B, H, W, D); mask/ind (B, M); target (B, M, D)."""
    b, h, w, d = output.shape
    pred = _gather_feat(output.reshape(b, h * w, d), ind)
    m = mask.to(output.dtype)[..., None]
    loss = torch.abs(pred * m - target * m)
    loss = loss / (global_sum(m.sum()) + 1e-4)
    return loss.sum(dim=(0, 1))


def sigmoid_focal_loss(logits, target, gamma=2.0, alpha=0.25):
    """Sigmoid focal loss summed over every element (reduction 'sum')."""
    pred = torch.clamp(
        torch.exp(-torch.logaddexp(torch.zeros_like(logits), -logits)),
        1e-12, 1 - 1e-12)
    alpha_w = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1 - pred) + (1 - target) * pred
    bce = (torch.clamp(logits, min=0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    return (alpha_w * torch.pow(pt, gamma) * bce).sum()


def smooth_l1(x, sigma=3.0):
    """Per-element smooth L1 with its transition at 1 / sigma^2."""
    sigma2 = sigma ** 2
    absx = x.abs()
    return torch.where(absx < 1.0 / sigma2, 0.5 * (sigma * x) ** 2,
                       absx - 0.5 / sigma2)
