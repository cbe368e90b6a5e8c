"""Fused vote-Swin window attention: CUDA kernel and its plain PyTorch twin.

Counterpart of ``partner_tpu/ops/swin_attn_pallas.py:swin_vote_attention``.
Per window and head: an RPE MLP 2 -> hidden -> nh over f32 pairwise
position deltas (ReLU hidden); cosine logits ``q.k / (|q| |k|)`` from the
f32-accumulated product, with eps 1e-12 inside the sqrt; / tau (already
clamped >= 0.01); + RPE; + the optional region mask; softmax; ``P.V`` with
``P`` cast to the value dtype and an f32-accumulated product.

The logits are divided by the norm product, as the TPU kernel does, not
computed from pre-normalized bf16 q/k as the JAX package's plain path
(``swin_vote.py:182-188``) does; the two differ by rounding only.

:func:`swin_vote_attention` is the plain twin on every device (a frozen
copy for the benchmark's reference: no kernel, no launch count).
kernel takes one window per block over all 4 heads: both products on the
tensor cores (``mma.sync``), logits and softmax in registers, and the RPE
MLP evaluated once per window into a shared table for all heads (the
source note has the design and its rounding).
"""

import torch


# the shapes csrc/swin_attn.cu is compiled for
T, HD, HIDDEN, NH = 64, 64, 16, 4


def swin_vote_attention_plain(q, k, v, pos, mask, w1, b1, w2, b2, tau):
    """Cosine window attention with RPE-MLP bias and region mask.

    Args:
      q, k, v: (nW, nh, T, hd) compute dtype (vote embedding already added).
      pos: (nW, T, 2) f32 window cell centers.
      mask: (nWm, T, T) f32 additive region mask with nW % nWm == 0 (window
        w takes mask[w % nWm], the per-sample tiling of the JAX caller), or
        None for unshifted blocks.
      w1: (2, H), b1: (H,), w2: (H, nh), b2: (nh,) RPE MLP params (f32).
      tau: (nh,) f32 clamped temperature.
    Returns (nW, nh, T, hd) attention output in q.dtype.
    """
    nw, nh, t, _ = q.shape
    qf, kf = q.float(), k.float()
    qn = torch.sqrt((qf * qf).sum(-1, keepdim=True) + 1e-12)
    kn = torch.sqrt((kf * kf).sum(-1, keepdim=True) + 1e-12)
    logits = qf @ kf.transpose(-1, -2)
    logits = logits / (qn * kn.transpose(-1, -2))
    logits = logits / tau.float()[None, :, None, None]
    posf = pos.float()
    rel = posf[:, :, None, :] - posf[:, None, :, :]          # (nW, T, T, 2)
    hidden = torch.relu(rel @ w1.float() + b1.float())
    rpe = hidden @ w2.float() + b2.float()                  # (nW, T, T, nh)
    logits = logits + rpe.permute(0, 3, 1, 2)
    if mask is not None:
        nm = mask.shape[0]
        logits = (logits.reshape(nw // nm, nm, nh, t, t)
                  + mask.float()[None, :, None]).reshape(nw, nh, t, t)
    logits = logits - logits.amax(-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(-1, keepdim=True)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


# the reference runs the plain twin on every device
swin_vote_attention = swin_vote_attention_plain

