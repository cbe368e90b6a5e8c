"""PARTNER re-alignment attention, SetBlock stack.

Counterpart of ``partner_tpu/models/set_transformer.py``. The module works
on the polar BEV map (B, H=range, W=azimuth, C) and per-cell cartesian
positions, and routes global context through Hk keypoints per azimuth
column: keypoint init (saliency, local max along range, top-Hk), keypoints
attend to their column (SectorAttention), keypoint windows attend to each
other (RangeAttention), cells query their column's keypoints
(SectorBroadcast), then residual + MLP; odd blocks shift the azimuth axis.

Each relative-position bias runs as in the JAX package: decomposed per
token at inference (:func:`layers.decompose_pos_mlp`), and in train mode
directly on the (..., 2) pair tensor, whose BatchNorm then takes that
tensor's batch statistics. Dropout, attention dropout and DropPath sit
where the JAX modules have them and draw from the generator passed to
``forward`` (train mode only). Products written with
``preferred_element_type=f32`` in JAX take float32 operands here, which is
the same function for bf16 inputs.
"""

import torch
import torch.nn as nn

from .layers import (Dense, DropPath, Dropout, LayerNorm, Mlp, PosEmbedMLP,
                     decompose_pos_mlp)


def _pair_bias(mlp, pos_a, pos_b, a_axis, b_axis):
    """mlp(pos_a - pos_b) with broadcast axes: on the pair tensor in train
    mode, decomposed per token otherwise."""
    if mlp.training:
        return mlp(pos_a.unsqueeze(a_axis) - pos_b.unsqueeze(b_axis))
    proj, finish = decompose_pos_mlp(mlp, mlp.dtype)
    return finish(proj(pos_a).unsqueeze(a_axis)
                  - proj(pos_b).unsqueeze(b_axis))


def _split_heads(x, nh):
    return x.reshape(*x.shape[:-1], nh, x.shape[-1] // nh)


def _einsum_f32(eq, a, b):
    return torch.einsum(eq, a.float(), b.float())


def _scaled(q, c, nh):
    """q * (c // nh) ** -0.5, the scale rounded to q's dtype as in JAX."""
    return q * torch.tensor((c // nh) ** -0.5, dtype=q.dtype).item()


class SectorAttention(nn.Module):
    """Keypoints (B, Hk, W, C) attend to their azimuth column (B, H, W, C)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, drop=0.0, attn_drop=0.0,
                 drop_path=0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.proj_q = Dense(dim, dim, dtype=dtype)
        self.proj_k = Dense(dim, dim, dtype=dtype)
        self.proj_v = Dense(dim, dim, dtype=dtype)
        self.pos_mlp = PosEmbedMLP(num_heads, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, drop, dtype=dtype)
        self.attn_drop = Dropout(attn_drop)
        self.drop_path = DropPath(drop_path)

    def forward(self, s, x, s_pos, x_pos, generator=None):
        c = s.shape[-1]
        nh, dt = self.num_heads, self.dtype
        shortcut = s
        q = _split_heads(self.proj_q(s.to(dt)), nh)
        k = _split_heads(self.proj_k(x.to(dt)), nh)
        v = _split_heads(self.proj_v(x.to(dt)), nh)
        attn = _einsum_f32("bqwhd,bkwhd->bwhqk", _scaled(q, c, nh), k)
        bias = _pair_bias(self.pos_mlp, s_pos, x_pos, 2, 1)
        attn = attn + bias.permute(0, 3, 4, 1, 2).float()
        attn = torch.softmax(attn, dim=-1).to(dt)
        attn = self.attn_drop(attn, generator)
        out = _einsum_f32("bwhqk,bkwhd->bqwhd", attn, v).to(dt)
        out = self.proj(out.reshape(s.shape)).float()
        s = shortcut + self.drop_path(out, generator)
        mlp = self.Mlp_0(self.norm2(s), generator).float()
        return s + self.drop_path(mlp, generator)


class RangeAttention(nn.Module):
    """Keypoint self-attention over (Hk, range_window) windows."""

    def __init__(self, dim, num_heads, window_w=8, mlp_ratio=4.0, drop=0.0,
                 attn_drop=0.0, drop_path=0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_w = window_w
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.proj_q = Dense(dim, dim, dtype=dtype)
        self.proj_k = Dense(dim, dim, dtype=dtype)
        self.proj_v = Dense(dim, dim, dtype=dtype)
        self.pos_mlp = PosEmbedMLP(num_heads, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, drop, dtype=dtype)
        self.attn_drop = Dropout(attn_drop)
        self.drop_path = DropPath(drop_path)

    def forward(self, s, s_pos, generator=None):
        dt = self.dtype
        b, hk, w, c = s.shape
        nh, ww = self.num_heads, self.window_w
        nw = w // ww
        shortcut = s

        def to_windows(t):
            # (B, Hk, W, C) -> (B, nw, Hk*ww, C), tokens h-major per window
            t = t.reshape(b, hk, nw, ww, -1)
            return t.permute(0, 2, 1, 3, 4).reshape(b, nw, hk * ww, -1)

        yw = to_windows(self.norm1(s)).to(dt)
        pw = to_windows(s_pos)
        q = _split_heads(self.proj_q(yw), nh)
        k = _split_heads(self.proj_k(yw), nh)
        v = _split_heads(self.proj_v(yw), nh)
        attn = _einsum_f32("bnqhd,bnkhd->bnhqk", _scaled(q, c, nh), k)
        bias = _pair_bias(self.pos_mlp, pw, pw, 3, 2)
        attn = attn + bias.permute(0, 1, 4, 2, 3).float()
        attn = torch.softmax(attn, dim=-1).to(dt)
        attn = self.attn_drop(attn, generator)
        out = _einsum_f32("bnhqk,bnkhd->bnqhd", attn, v).to(dt)
        out = out.reshape(b, nw, hk, ww, c).permute(0, 2, 1, 3, 4).reshape(
            b, hk, w, c)
        s = shortcut + self.drop_path(self.proj(out).float(), generator)
        mlp = self.Mlp_0(self.norm2(s), generator).float()
        return s + self.drop_path(mlp, generator)


class SectorBroadcast(nn.Module):
    """Cells (B, H, W, C) query their column's keypoints (B, Hk, W, C); no
    residual or output projection inside."""

    def __init__(self, dim, num_heads, attn_drop=0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.proj_q = Dense(dim, dim, dtype=dtype)
        self.proj_k = Dense(dim, dim, dtype=dtype)
        self.proj_v = Dense(dim, dim, dtype=dtype)
        self.pos_mlp = PosEmbedMLP(num_heads, dtype=dtype)
        self.attn_drop = Dropout(attn_drop)

    def forward(self, s, x, s_pos, x_pos, generator=None):
        c = x.shape[-1]
        nh, dt = self.num_heads, self.dtype
        q = _split_heads(self.proj_q(x.to(dt)), nh)
        k = _split_heads(self.proj_k(s.to(dt)), nh)
        v = _split_heads(self.proj_v(s.to(dt)), nh)
        attn = _einsum_f32("bqwhd,bkwhd->bwhqk", _scaled(q, c, nh), k)
        bias = _pair_bias(self.pos_mlp, x_pos, s_pos, 2, 1)
        attn = attn + bias.permute(0, 3, 4, 1, 2).float()
        attn = torch.softmax(attn, dim=-1).to(dt)
        attn = self.attn_drop(attn, generator)
        out = _einsum_f32("bwhqk,bkwhd->bqwhd", attn, v)
        return out.reshape(x.shape)


def topk_lower_index_first(x, k):
    """Indices of the k largest along the last axis, ties to the lower
    index (the ``jax.lax.top_k`` rule; ``torch.topk`` promises no order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class SetAttention(nn.Module):
    """One re-alignment round: keypoint init + 3 attentions + MLP."""

    def __init__(self, dim, num_heads=4, num_keypoints=4, range_window=8,
                 shift=False, drop=0.0, attn_drop=0.0, drop_path=0.0,
                 mlp_ratio=4.0, dtype=torch.float32):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.shift = (range_window // 2) if shift else 0
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.sector_attn1 = SectorAttention(dim, num_heads, mlp_ratio, drop,
                                            attn_drop, drop_path, dtype)
        self.range_attn = RangeAttention(dim, num_heads, range_window,
                                         mlp_ratio, drop, attn_drop,
                                         drop_path, dtype)
        self.sector_attn2 = SectorBroadcast(dim, num_heads, attn_drop, dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, drop, dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, pos, generator=None):
        c = x.shape[-1]
        shift = self.shift
        shortcut = x
        x = self.norm1(x)
        if shift:
            x = torch.roll(x, -shift, dims=2)
            pos = torch.roll(pos, -shift, dims=2)

        # keypoint init: saliency -> local max along range -> top-k per column
        sal = x.mean(-1)  # (B, H, W)
        inner = torch.maximum(torch.maximum(sal[:, :-2], sal[:, 1:-1]),
                              sal[:, 2:])
        local_max = torch.zeros_like(sal)
        local_max[:, 1:-1] = inner
        sal = torch.where(local_max == sal, sal, torch.zeros_like(sal))
        top_idx = topk_lower_index_first(sal.transpose(1, 2),
                                         self.num_keypoints).transpose(1, 2)
        s = torch.gather(x, 1, top_idx[..., None].expand(-1, -1, -1, c))
        s_pos = torch.gather(pos, 1, top_idx[..., None].expand(-1, -1, -1, 2))

        s = self.sector_attn1(s, x, s_pos, pos, generator)
        s = self.range_attn(s, s_pos, generator)
        x = self.sector_attn2(s, x, s_pos, pos, generator)
        if shift:
            x = torch.roll(x, shift, dims=2)

        x = shortcut + self.drop_path(self.proj(x.to(self.dtype)).float(),
                                      generator)
        mlp = self.Mlp_0(self.norm2(x), generator).float()
        return x + self.drop_path(mlp, generator)


class SetBlockStack(nn.Module):
    """Depth-N SetAttention stack with alternating shift. The drop rates
    default to the JAX module's 0.1 (the flagship sets 0.0, 0.0, 0.1)."""

    def __init__(self, dim, depth=2, num_heads=4, num_keypoints=4,
                 range_window=8, drop=0.1, attn_drop=0.1, drop_path=0.1,
                 mlp_ratio=4.0, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", SetAttention(
                dim, num_heads, num_keypoints, range_window,
                shift=(i % 2 == 1), drop=drop, attn_drop=attn_drop,
                drop_path=drop_path, mlp_ratio=mlp_ratio, dtype=dtype))

    def forward(self, x, pos, generator=None):
        """x (B, H, W, C) f32, pos (B, H, W, 2); ``generator`` feeds the
        dropout and DropPath draws in train mode."""
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, pos, generator)
        return x
