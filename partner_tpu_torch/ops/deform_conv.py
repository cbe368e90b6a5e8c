"""Deformable convolution v1/v2 as a bilinear gather and a matmul.

Counterpart of ``partner_tpu/ops/deform_conv.py``, which computes it in
plain XLA (there is no Pallas kernel): each of the K = kernel x kernel
taps samples the input at ``p + tap offset + learned offset`` with
bilinear interpolation, zero outside the image, giving a (B, H, W, K, C)
tensor that contracts with the (K, C, Cout) weight in float32.

The offsets are laid out as torch's DCN lays them out: per deformable
group, per tap, a (dy, dx) pair, so ``offsets.reshape(B, H, W, G, K, 2)``
holds dy at ``[..., 0]`` and dx at ``[..., 1]``. The v2 (modulated)
variant multiplies each tap's sample by the sigmoid of a mask logit.

Plain torch with autograd (indexing for the gather, ``einsum`` for the
product), on the CPU and on the card alike: the backward reaches the
input, the offsets, the mask and the weight.
"""

import torch


def bilinear_sample_nhwc(x, ys, xs):
    """Sample ``x`` (B, H, W, C) at float coordinates ``ys``, ``xs`` (each
    (B, H, W, K)) -> (B, H, W, K, C). The four taps are clipped into the
    image and a tap outside it contributes zero."""
    b, h, w, c = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0   # weight of the +1 row
    wx1 = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    xf = x.reshape(b * h * w, c)
    first = (torch.arange(b, device=x.device) * (h * w)).view(b, 1, 1, 1)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + first
        g = xf[lin.reshape(-1)].reshape(yi.shape + (c,))
        return g * valid[..., None].to(x.dtype)

    v00 = tap(y0i, x0i) * ((1 - wy1) * (1 - wx1))[..., None]
    v01 = tap(y0i, x0i + 1) * ((1 - wy1) * wx1)[..., None]
    v10 = tap(y0i + 1, x0i) * (wy1 * (1 - wx1))[..., None]
    v11 = tap(y0i + 1, x0i + 1) * (wy1 * wx1)[..., None]
    return v00 + v01 + v10 + v11


def deform_conv2d(x, offsets, weights, bias=None, kernel=3,
                  deformable_groups=1, mask=None):
    """Deformable 2D convolution, stride 1, SAME padding.

    Args:
      x: (B, H, W, C) input.
      offsets: (B, H, W, G*K*2) learned offsets in torch DCN's layout (the
        module docstring); G = ``deformable_groups``, K = kernel^2.
      weights: (K, C, Cout).
      bias: optional (Cout,).
      mask: optional (B, H, W, G*K) modulation logits (DCN v2); the
        sigmoid is applied here.

    Returns (B, H, W, Cout) in ``x``'s dtype; the product accumulates in
    float32."""
    b, h, w, c = x.shape
    g = deformable_groups
    k = kernel * kernel
    if offsets.shape[-1] != g * k * 2 or c % g:
        raise ValueError(f"deform_conv2d: offsets {tuple(offsets.shape)}, "
                         f"{c} channels, {g} groups, {k} taps")
    pad = (kernel - 1) // 2
    taps = torch.arange(kernel, dtype=x.dtype, device=x.device) - pad
    ky, kx = torch.meshgrid(taps, taps, indexing="ij")
    base_y = torch.arange(h, dtype=x.dtype, device=x.device).view(
        1, h, 1, 1, 1)
    base_x = torch.arange(w, dtype=x.dtype, device=x.device).view(
        1, 1, w, 1, 1)
    off = offsets.reshape(b, h, w, g, k, 2)
    ys = base_y + ky.reshape(-1) + off[..., 0]   # (B, H, W, G, K)
    xs = base_x + kx.reshape(-1) + off[..., 1]

    # the groups as samples of one gather: (B * G, H, W, ...)
    by_group = lambda t: t.movedim(3, 1).reshape((b * g, h, w) + t.shape[4:])
    s = bilinear_sample_nhwc(by_group(x.reshape(b, h, w, g, c // g)),
                             by_group(ys), by_group(xs))  # (BG, H, W, K, C/G)
    if mask is not None:
        s = s * torch.sigmoid(by_group(mask.reshape(b, h, w, g, k)))[..., None]
    samp = s.reshape(b, g, h, w, k, c // g).movedim(1, 4).reshape(
        b, h, w, k, c)
    out = torch.einsum("bhwkc,kco->bhwo", samp.float(),
                       weights.float()).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out
