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

:func:`swin_vote_attention` launches ``csrc/swin_attn.cu`` for CUDA tensors
and runs :func:`swin_vote_attention_plain` for CPU tensors; there is no
other switch. ``swin_vote_attention.launches`` counts kernel launches;
a launch also charges its twin's FLOPs to an open ``utils.flops`` count. The
kernel takes one window per block over all 4 heads: both products on the
tensor cores (``mma.sync``), logits and softmax in registers, and the RPE
MLP evaluated once per window into a shared table for all heads (the
source note has the design and its rounding).
"""

import torch

from . import _cuda
from ..utils import flops as _flops

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


def swin_vote_attention(q, k, v, pos, mask, w1, b1, w2, b2, tau):
    """Fused window attention: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors. Same arguments and result as
    :func:`swin_vote_attention_plain`; the kernel takes bf16 q/k/v with
    4 heads, T = 64, hd = 64 and an RPE hidden width of 16, every tensor
    contiguous, and q, k, v, pos and the mask 16-byte aligned. Forward
    only: it raises when an input needs a gradient under grad mode."""
    _cuda.refuse_autograd("swin_attn", q, k, v, pos, mask, w1, b1, w2, b2,
                          tau)
    if q.device.type == "cpu":
        return swin_vote_attention_plain(q, k, v, pos, mask, w1, b1, w2, b2,
                                         tau)
    req = _cuda.require
    req(q.device.type == "cuda", f"swin_attn: unsupported device {q.device}")
    nw, nh, t, hd = q.shape
    req((nh, t, hd, w1.shape[1]) == (NH, T, HD, HIDDEN),
        f"swin_attn kernel is built for nh, T, hd, hidden = "
        f"{NH, T, HD, HIDDEN}; got {nh, t, hd, w1.shape[1]}")
    nwm = nw if mask is None else mask.shape[0]
    req(nwm > 0 and nw % nwm == 0, "swin_attn: mask windows must divide nW")
    f32, bf16 = torch.float32, torch.bfloat16
    args = [("q", q, bf16, (nw, nh, T, HD)), ("k", k, bf16, (nw, nh, T, HD)),
            ("v", v, bf16, (nw, nh, T, HD)), ("pos", pos, f32, (nw, T, 2)),
            ("w1", w1, f32, (2, HIDDEN)), ("b1", b1, f32, (HIDDEN,)),
            ("w2", w2, f32, (HIDDEN, nh)), ("b2", b2, f32, (nh,)),
            ("tau", tau, f32, (nh,))]
    if mask is not None:
        args.append(("mask", mask, f32, (nwm, T, T)))
    for name, x, dt, shape in args:
        req(x.device == q.device, f"swin_attn: {name} on {x.device}")
        req(x.dtype == dt, f"swin_attn: {name} must be {dt}, got {x.dtype}")
        req(tuple(x.shape) == shape,
            f"swin_attn: {name} shape {tuple(x.shape)} != {shape}")
        req(x.is_contiguous(), f"swin_attn: {name} must be contiguous")
        if name in ("q", "k", "v", "pos", "mask"):  # copied 16 bytes a time
            req(x.data_ptr() % 16 == 0,
                f"swin_attn: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if nw == 0:
        return out
    lib = _cuda.library().lib
    err = lib.ptt_swin_attn_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        None if mask is None else mask.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        tau.data_ptr(), out.data_ptr(), nw, nh, nwm,
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "swin_attn")
    swin_vote_attention.launches += 1
    if _flops.active:
        _flops.charge("swin_attn", _flops.swin_attn_flops(q, w1, w2))
    return out


swin_vote_attention.launches = 0
