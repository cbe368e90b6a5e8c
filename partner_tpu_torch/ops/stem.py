"""Fused two-layer point stem: CUDA kernel and its plain PyTorch twin.

Counterpart of ``partner_tpu/ops/stem_pallas.py:stem2_channel_major``.
The flagship's point path runs a 2-layer channel-major MLP over the padded
point buffer (``backbone_dense.PolarDenseFHD._stem_t``). Per layer: matmul
with f32 accumulation -> cast to the compute dtype -> x point mask ->
folded BatchNorm ``t * a + b`` in f32 -> ReLU -> cast, where
``a = scale * rsqrt(var + eps)`` and ``b = shift - mean * a``.

:func:`stem2_channel_major` launches ``csrc/stem.cu`` for CUDA tensors and
runs :func:`stem2_channel_major_plain` for CPU tensors; there is no other
switch. ``stem2_channel_major.launches`` counts kernel launches.
"""

import torch

from . import _cuda

# the shapes csrc/stem.cu is compiled for: C_in 10 (7 point features + 3
# decorations) or 11 (the two-sweep configs' 8 + 3), F1, F2
CINS, F1, F2 = (10, 11), 32, 64


def stem2_channel_major_plain(x, mask, w1, a1, b1, w2, a2, b2):
    """Two stem layers, channel-major, in plain PyTorch.

    Args:
      x: (B, C_in, P) compute-dtype decorated point features.
      mask: (B, P) bool point validity.
      w1: (F1, C_in), w2: (F2, F1) compute-dtype kernels (transposed).
      a1, b1: (F1,) f32 folded BN affine; a2, b2: (F2,).
    Returns (B, F2, P) compute-dtype stem features.
    """
    cdt = x.dtype
    m = mask[:, None, :].to(cdt)
    t = x
    for w, a, b in ((w1, a1, b1), (w2, a2, b2)):
        # products of compute-dtype values are exact in f32: this is the
        # f32-accumulated matmul of the kernel
        acc = w.float() @ t.float()
        acc = (acc.to(cdt) * m).float()
        acc = acc * a[:, None].float() + b[:, None].float()
        t = torch.relu(acc).to(cdt)
    return t


def stem2_channel_major(x, mask, w1, a1, b1, w2, a2, b2):
    """Fused stem: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors. Same arguments and result as :func:`stem2_channel_major_plain`;
    the kernel takes bf16 features with C_in in ``CINS`` (one instantiation
    each) and (F1, F2) = (32, 64), any P, and a w2 at a 4-byte boundary.
    Forward only: it raises when an input needs a gradient under grad
    mode."""
    _cuda.refuse_autograd("stem", x, w1, a1, b1, w2, a2, b2)
    if x.device.type == "cpu":
        return stem2_channel_major_plain(x, mask, w1, a1, b1, w2, a2, b2)
    req = _cuda.require
    req(x.device.type == "cuda", f"stem: unsupported device {x.device}")
    req(x.dim() == 3, f"stem: x must be (B, C_in, P), got {tuple(x.shape)}")
    bsz, cin, p = x.shape
    req(cin in CINS, f"stem: C_in {cin}; the kernel is built for C_in in "
        f"{CINS}")
    f32, bf16 = torch.float32, torch.bfloat16
    for name, t, dt, shape in (
            ("x", x, bf16, (bsz, cin, p)), ("mask", mask, torch.bool, (bsz, p)),
            ("w1", w1, bf16, (F1, cin)), ("w2", w2, bf16, (F2, F1)),
            ("a1", a1, f32, (F1,)), ("b1", b1, f32, (F1,)),
            ("a2", a2, f32, (F2,)), ("b2", b2, f32, (F2,))):
        req(t.device == x.device, f"stem: {name} on {t.device}, x on {x.device}")
        req(t.dtype == dt, f"stem: {name} must be {dt}, got {t.dtype}")
        req(tuple(t.shape) == shape,
            f"stem: {name} shape {tuple(t.shape)} != {shape} (the kernel is "
            f"built for F1, F2 = {F1, F2})")
        req(t.is_contiguous(), f"stem: {name} must be contiguous")
    req(w2.data_ptr() % 4 == 0, "stem: w2 must start at a 4-byte boundary")
    out = torch.empty((bsz, F2, p), dtype=torch.bfloat16, device=x.device)
    if bsz == 0 or p == 0:
        return out
    lib = _cuda.library().lib
    err = lib.ptt_stem2_bf16(
        x.data_ptr(), mask.data_ptr(), w1.data_ptr(), a1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), a2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), bsz, p, cin, _cuda.stream_ptr(x.device))
    _cuda.check(err, "stem2")
    stem2_channel_major.launches += 1
    return out


stem2_channel_major.launches = 0
