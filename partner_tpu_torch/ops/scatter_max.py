"""Scatter-max of point features into the z-folded canvas: CUDA kernel, its
plain PyTorch twin, and the autograd Function that trains through it.

Counterpart of ``tools/probes/pallas_scatter_stripe.py:pallas_scatter``
and of what it stands for on the main path, ``scatter_canvas(fold2d=True)``
(``partner_tpu/models/backbone_dense.py:152-163,223-240``): a max of
post-ReLU point rows into a zero-initialized canvas with a z-minor linear
cell index, so that folding z into the channels is a free reshape. Masked
rows are dropped.

The op reads the stem's channel-major ``(B, C, P)`` output as it is.

:func:`scatter_max_fold2d` launches ``csrc/scatter_max.cu`` for CUDA
tensors and runs :func:`scatter_max_fold2d_plain` for CPU tensors; there
is no other switch. ``scatter_max_fold2d.launches`` counts kernel launches.
It is forward only and refuses an input that needs a gradient;
:class:`ScatterMaxFold2d` runs it as the forward of an autograd Function
whose backward is the JAX package's custom VJP (``_scatter_max_rows_bwd``,
``backbone_dense.py:171-187``) in plain torch.
"""

import torch

from . import _cuda


def _cell_index(coords_t, mask, canvas_shape):
    """(B, P) z-minor cell index of each row; ``cells`` (one past the
    canvas) for masked rows."""
    cz, cy, cx = canvas_shape
    co = coords_t.long()
    lin = (co[:, 1] * cx + co[:, 2]) * cz + co[:, 0]
    return torch.where(mask, lin, torch.full_like(lin, cz * cy * cx))


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
    lin = _cell_index(coords_t, mask, canvas_shape)
    base = torch.zeros((b, cells + 1, c), dtype=x_t.dtype, device=x_t.device)
    base.scatter_reduce_(1, lin[..., None].expand(-1, -1, c),
                         x_t.transpose(1, 2), "amax", include_self=True)
    return base[:, :cells].reshape(b, cy, cx, cz * c)


# the kernel's C entry point for each feature dtype
_ENTRY = {torch.bfloat16: "ptt_scatter_max_bf16",
          torch.float32: "ptt_scatter_max_f32"}


def scatter_max_fold2d(x_t, coords_t, mask, canvas_shape):
    """Scatter-max into the z-folded canvas: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors. Same arguments and result as
    :func:`scatter_max_fold2d_plain` (values equal; a -0.0 input leaves
    +0.0); the kernel takes bf16 or float32 features with C a multiple of
    8 and a canvas of fewer than 2**31 cells. It drops a row whose coords
    fall outside the canvas where the twin raises. Forward only: it raises
    when ``x_t`` needs a gradient under grad mode (use
    :class:`ScatterMaxFold2d`)."""
    _cuda.refuse_autograd("scatter_max", x_t)
    if x_t.device.type == "cpu":
        return scatter_max_fold2d_plain(x_t, coords_t, mask, canvas_shape)
    req = _cuda.require
    req(x_t.device.type == "cuda",
        f"scatter_max: unsupported device {x_t.device}")
    req(x_t.dim() == 3, f"scatter_max: x_t must be (B, C, P), got {x_t.shape}")
    b, c, p = x_t.shape
    entry = _ENTRY.get(x_t.dtype)
    req(entry is not None,
        f"scatter_max: x_t must be bfloat16 or float32, got {x_t.dtype}")
    req(c % 8 == 0, f"scatter_max: the kernel takes C a multiple of 8, "
        f"got {c}")
    cz, cy, cx = (int(s) for s in canvas_shape)
    req(cz * cy * cx < 2 ** 31,
        f"scatter_max: {cz * cy * cx} cells, the kernel takes < 2**31")
    for name, t, dt, shape in (
            ("x_t", x_t, x_t.dtype, (b, c, p)),
            ("coords_t", coords_t, torch.int32, (b, 3, p)),
            ("mask", mask, torch.bool, (b, p))):
        req(t.device == x_t.device, f"scatter_max: {name} on {t.device}")
        req(t.dtype == dt, f"scatter_max: {name} must be {dt}, got {t.dtype}")
        req(tuple(t.shape) == shape,
            f"scatter_max: {name} shape {tuple(t.shape)} != {shape}")
        req(t.is_contiguous(), f"scatter_max: {name} must be contiguous")
    canvas = torch.zeros((b, cy * cx * cz, c), dtype=x_t.dtype,
                         device=x_t.device)
    if b * p == 0:
        return canvas.reshape(b, cy, cx, cz * c)
    err = getattr(_cuda.library().lib, entry)(
        x_t.data_ptr(), coords_t.data_ptr(), mask.data_ptr(),
        canvas.data_ptr(), b, p, c, cz, cy, cx, _cuda.stream_ptr(x_t.device))
    _cuda.check(err, "scatter_max")
    scatter_max_fold2d.launches += 1
    return canvas.reshape(b, cy, cx, cz * c)


scatter_max_fold2d.launches = 0


def scatter_max_fold2d_backward(x_t, coords_t, mask, canvas, g, canvas_shape):
    """The JAX package's scatter-max VJP (``_scatter_max_rows_bwd``) in
    plain torch: each row takes the cotangent of its cell where its value
    equals the cell's max, and masked rows take none. ``canvas`` is the
    forward's result and ``g`` its cotangent, both (B, cy, cx, cz * C);
    returns the gradient of ``x_t``, (B, C, P)."""
    b, c, _ = x_t.shape
    # masked rows gather cell 0 and are zeroed by the mask below
    lin = _cell_index(coords_t, mask, canvas_shape)
    idx = torch.where(mask, lin, 0)[..., None].expand(-1, -1, c)

    def at_row(t):   # (B, cy, cx, cz*C) -> (B, C, P) at each row's cell
        return torch.gather(t.reshape(b, -1, c), 1, idx).transpose(1, 2)

    won = (x_t == at_row(canvas)) & mask[:, None, :]
    gx = torch.where(won, at_row(g), torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
    return gx.to(x_t.dtype)


class ScatterMaxFold2d(torch.autograd.Function):
    """:func:`scatter_max_fold2d` with the JAX package's backward,
    :func:`scatter_max_fold2d_backward`.

    Tie rule (``_scatter_max_rows_bwd``): every row whose value equals its
    cell's max takes the cell's full cotangent, and masked rows take none.
    Torch's own ``scatter_reduce(amax)`` backward would split it among the
    tied rows, and give a share to a zero that ties the zero base. The
    compare is a float compare, so a -0.0 stem row that the kernel stored
    as +0.0 still wins. Gradients flow to ``x_t`` only.

        canvas = ScatterMaxFold2d.apply(x_t, coords_t, mask, canvas_shape)
    """

    @staticmethod
    def forward(ctx, x_t, coords_t, mask, canvas_shape):
        canvas = scatter_max_fold2d(x_t, coords_t, mask, canvas_shape)
        ctx.save_for_backward(x_t, coords_t, mask, canvas)
        ctx.canvas_shape = tuple(int(s) for s in canvas_shape)
        return canvas

    @staticmethod
    def backward(ctx, g):
        x_t, coords_t, mask, canvas = ctx.saved_tensors
        return (scatter_max_fold2d_backward(x_t, coords_t, mask, canvas, g,
                                            ctx.canvas_shape),
                None, None, None)
