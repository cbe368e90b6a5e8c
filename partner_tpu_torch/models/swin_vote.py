"""Vote-conditioned Swin window attention (counterpart of
``partner_tpu/models/swin_vote.py``), inference.

- patch embed 1x1 conv in_ch -> embed_dim + LayerNorm;
- ``depth`` SwinVoteBlocks, window ``ws``, alternating shift 0 / ws//2 with
  the standard Swin region-id mask;
- WindowAttention: cosine attention with a per-head temperature tau
  (clamped >= 0.01), a vote embedding MLP(3 -> 16 -> C) added to q, k and
  v, and a relative-position-bias MLP(2 -> 16 -> heads) over pairwise
  cartesian deltas inside the window;
- final LayerNorm. Feature maps are NHWC (B, H=azimuth, W=range, C).

The attention core always runs through :func:`ops.swin_attn.swin_vote_attention`
(the CUDA kernel for CUDA tensors, its plain twin for CPU tensors): the
JAX package's kernel route. Not ported yet: the static-RPE cache, the
whole-block kernel route, and maps that do not tile into whole windows
(the pad-mask path).
"""

import numpy as np
import torch
import torch.nn as nn

from ..ops import swin_attn
from ..utils.dtypes import resolve_compute_dtype
from .layers import Conv2d, Dense, LayerNorm, constant, gelu


class VoteMLP(nn.Module):
    def __init__(self, features, hidden=16, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(3, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, features, dtype=dtype)

    def forward(self, v):
        return self.Dense_1(torch.relu(self.Dense_0(v)))


class RPEMLP(nn.Module):
    """Relative-position bias MLP parameters; the attention kernel (and its
    plain twin) evaluates them."""

    def __init__(self, num_heads, hidden=16, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(2, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, num_heads, dtype=dtype)


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win, ws, b, h, w):
    c = win.shape[-1]
    x = win.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def swin_attn_mask(hp, wp, ws, shift):
    """Standard Swin region-id mask for shifted windows as a numpy
    (num_windows, T, T) float32 additive mask (0 / -100); None for
    shift == 0."""
    if shift == 0:
        return None
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, hp // ws, ws, wp // ws, ws, 1).transpose(
        0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.vote_mlp = VoteMLP(dim, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.rpe = RPEMLP(num_heads, dtype=dtype)
        self.tau = nn.Parameter(torch.empty(1, num_heads, 1, 1))
        self.proj = Dense(dim, dim, dtype=dtype)

    def init_extra(self, generator):
        self.tau.data.fill_(1.0)

    def forward(self, x, pos, vote, mask=None):
        """x (nB, T, C); pos (nB, T, 2) f32; vote (nB, T, 3); mask
        (nW, T, T) f32 or None, window w taking mask[w % nW]."""
        nb, t, c = x.shape
        nh = self.num_heads
        hd = c // nh
        dt = self.dtype
        ve = self.vote_mlp(vote.to(dt)).reshape(nb, t, nh, hd).transpose(1, 2)
        qkv = self.qkv(x.to(dt)).reshape(nb, t, 3, nh, hd).permute(
            2, 0, 3, 1, 4)
        q, k, v = ((qkv[i] + ve).contiguous() for i in range(3))
        rp = self.rpe
        out = swin_attn.swin_vote_attention(
            q, k, v, pos.float().contiguous(), mask,
            rp.Dense_0.weight.t().float().contiguous(),
            rp.Dense_0.bias.float().contiguous(),
            rp.Dense_1.weight.t().float().contiguous(),
            rp.Dense_1.bias.float().contiguous(),
            torch.clamp(self.tau, min=0.01).reshape(nh).contiguous())
        return self.proj(out.transpose(1, 2).reshape(nb, t, c))


class SwinVoteBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size=7, shift_size=0,
                 mlp_ratio=1.0, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x, pos, vote):
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        if h % ws or w % ws:
            raise ValueError(f"map {h}x{w} does not tile into {ws}x{ws} "
                             "windows (the pad-mask path is not ported)")
        shortcut = x
        x = self.norm1(x)
        if shift:
            x, pos, vote = (torch.roll(t, (-shift, -shift), dims=(1, 2))
                            for t in (x, pos, vote))
        mask = constant(self, f"mask{h}x{w}", x.device,
                        lambda: swin_attn_mask(h, w, ws, shift))
        out = self.attn(window_partition(x, ws), window_partition(pos, ws),
                        window_partition(vote, ws), mask)
        out = window_reverse(out, ws, b, h, w)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = shortcut + out.float()
        y = self.mlp_fc1(self.norm2(x).to(self.dtype))
        y = self.mlp_fc2(gelu(y))
        return x + y.float()


class SwinVoteTransformer(nn.Module):
    """SwVoteHeadV4: patch-embed + depth blocks + final LayerNorm."""

    def __init__(self, in_channels, embed_dim=256, depth=2, num_heads=4,
                 window_size=7, mlp_ratio=1.0, compute_dtype="float32"):
        super().__init__()
        dt = resolve_compute_dtype(compute_dtype)
        self.depth = depth
        self.patch_embed = Conv2d(in_channels, embed_dim, 1, dtype=dt)
        self.patch_norm = LayerNorm(embed_dim)
        for i in range(depth):
            setattr(self, f"block{i}", SwinVoteBlock(
                embed_dim, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio, dtype=dt))
        self.norm_out = LayerNorm(embed_dim)

    def forward(self, x, pos, vote):
        """x (B, H, W, in_ch); pos (B, H, W, 2); vote (B, H, W, 3)."""
        x = self.patch_norm(self.patch_embed(x).float())
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, pos, vote)
        return self.norm_out(x)
