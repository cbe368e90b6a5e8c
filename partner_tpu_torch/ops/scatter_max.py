"""Scatter-max of point features into the z-folded canvas: CUDA kernel and
its plain PyTorch twin.

Counterpart of ``tools/probes/pallas_scatter_stripe.py:pallas_scatter``
and of what it stands for on the main path, ``scatter_canvas(fold2d=True)``
(``partner_tpu/models/backbone_dense.py:152-163,223-240``): a max of
post-ReLU point rows into a zero-initialized canvas with a z-minor linear
cell index, so that folding z into the channels is a free reshape. Masked
rows are dropped.

The op reads the stem's channel-major ``(B, C, P)`` output as it is.
Forward only: the backward, with the JAX package's tie rule, comes with
the train step.

:func:`scatter_max_fold2d` launches ``csrc/scatter_max.cu`` for CUDA
tensors and runs :func:`scatter_max_fold2d_plain` for CPU tensors; there
is no other switch. ``scatter_max_fold2d.launches`` counts kernel launches.
"""

import torch

from . import _cuda


def scatter_max_fold2d_plain(x_t, coords_t, mask, canvas_shape):
    """Scatter-max channel-major point rows into a z-folded dense canvas.

    Args:
      x_t: (B, C, P) point features, non-negative (post-ReLU stem output):
        the canvas starts at zero, so empty cells read 0.
      coords_t: (B, 3, P) int32 canvas coords (z, az, r), channel-major;
        in range wherever ``mask`` is True.
      mask: (B, P) bool.
      canvas_shape: (cz, cy, cx).
    Returns (B, cy, cx, cz * C) in x_t.dtype, channel order [z0c0 ..
    z0c(C-1), z1c0, ...]. Masked rows go to a dump row past the canvas.
    """
    cz, cy, cx = canvas_shape
    cells = cz * cy * cx
    b, c, _ = x_t.shape
    co = coords_t.long()
    lin = (co[:, 1] * cx + co[:, 2]) * cz + co[:, 0]    # z-minor cell index
    lin = torch.where(mask, lin, torch.full_like(lin, cells))
    base = torch.zeros((b, cells + 1, c), dtype=x_t.dtype, device=x_t.device)
    base.scatter_reduce_(1, lin[..., None].expand(-1, -1, c),
                         x_t.transpose(1, 2), "amax", include_self=True)
    return base[:, :cells].reshape(b, cy, cx, cz * c)


def scatter_max_fold2d(x_t, coords_t, mask, canvas_shape):
    """Scatter-max into the z-folded canvas: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors. Same arguments and result as
    :func:`scatter_max_fold2d_plain` (values equal; a -0.0 input leaves
    +0.0); the kernel takes bf16 features with an even C. It drops a row
    whose coords fall outside the canvas where the twin raises."""
    if x_t.device.type == "cpu":
        return scatter_max_fold2d_plain(x_t, coords_t, mask, canvas_shape)
    req = _cuda.require
    req(x_t.device.type == "cuda",
        f"scatter_max: unsupported device {x_t.device}")
    req(x_t.dim() == 3, f"scatter_max: x_t must be (B, C, P), got {x_t.shape}")
    b, c, p = x_t.shape
    req(c % 2 == 0, f"scatter_max: the kernel takes an even C, got {c}")
    cz, cy, cx = (int(s) for s in canvas_shape)
    for name, t, dt, shape in (
            ("x_t", x_t, torch.bfloat16, (b, c, p)),
            ("coords_t", coords_t, torch.int32, (b, 3, p)),
            ("mask", mask, torch.bool, (b, p))):
        req(t.device == x_t.device, f"scatter_max: {name} on {t.device}")
        req(t.dtype == dt, f"scatter_max: {name} must be {dt}, got {t.dtype}")
        req(tuple(t.shape) == shape,
            f"scatter_max: {name} shape {tuple(t.shape)} != {shape}")
        req(t.is_contiguous(), f"scatter_max: {name} must be contiguous")
    canvas = torch.zeros((b, cy * cx * cz, c), dtype=torch.bfloat16,
                         device=x_t.device)
    if b * p == 0:
        return canvas.reshape(b, cy, cx, cz * c)
    lib = _cuda.library().lib
    err = lib.ptt_scatter_max_bf16(
        x_t.data_ptr(), coords_t.data_ptr(), mask.data_ptr(),
        canvas.data_ptr(), b, p, c, cz, cy, cx, _cuda.stream_ptr(x_t.device))
    _cuda.check(err, "scatter_max")
    scatter_max_fold2d.launches += 1
    return canvas.reshape(b, cy, cx, cz * c)


scatter_max_fold2d.launches = 0
