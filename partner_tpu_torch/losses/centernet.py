"""The element losses of the E2E set criterion (counterpart of
``sigmoid_focal_loss`` and ``smooth_l1`` in
``partner_tpu/losses/centernet.py:49-68``). ``fast_focal_loss`` and
``reg_loss`` belong to the CenterPoint head and are not ported."""

import torch


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
