"""CSWin transformer block on polar BEV token maps (counterpart of
``partner_tpu/models/cswin.py``).

The reference's cross-shaped-window attention: the channels split into two
branches, one attending within full-row stripes (along azimuth), one
within full-column stripes (along range), each with a conv-MLP
relative-position bias on supplied coordinates. No config builds it, in
either package; it is an alternative global-context block.

Plain torch, as in JAX (no Pallas kernel there): stripes are reshapes of
the NHWC map, attention one einsum per branch, and the relative-position
MLP runs on the (nWin, L, L, 2) float32 deltas. The JAX package's traps
hold: flax's LayerNorm eps 1e-6, the tanh GELU in ``Mlp``, the scale on q
before the product. flax creates a branch's position MLP only where it is
first called with ``pos``: ``pos=True`` builds it here, and a module built
without it takes no ``pos``. Parameter names are flax's, so
``convert.flax_to_torch`` maps them by its Dense and LayerNorm rules.
"""

import torch
from torch import nn

from .layers import Dense, LayerNorm, Mlp


def _stripes(x, h_sp, w_sp):
    """(B, H, W, C) -> (B * nH * nW, h_sp * w_sp, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // h_sp, h_sp, w // w_sp, w_sp, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h_sp * w_sp, c)


def _unstripes(x, h_sp, w_sp, h, w):
    """Inverse of _stripes."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // h_sp) * (w // w_sp))
    x = x.reshape(b, h // h_sp, w // w_sp, h_sp, w_sp, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class LePEAttention(nn.Module):
    """Stripe attention with an MLP relative-position bias. ``idx``
    selects the stripe: 0 = row stripes (1, W), 1 = column stripes (H, 1),
    -1 = square windows of ``split_size``. ``pos`` builds the position MLP
    (``pos_fc1`` 2 -> 16, ``pos_ln``, ReLU, ``pos_fc2`` 16 -> heads)."""

    def __init__(self, idx, num_heads, split_size=7, pos=True):
        super().__init__()
        self.idx = idx
        self.num_heads = num_heads
        self.split_size = split_size
        if pos:
            self.pos_fc1 = Dense(2, 16)
            self.pos_ln = LayerNorm(16)
            self.pos_fc2 = Dense(16, num_heads)

    def forward(self, q, k, v, pos=None):
        """q/k/v: (B, H, W, C); pos: (H, W, 2) coordinates or None."""
        b, h, w, c = q.shape
        if self.idx == 0:
            h_sp, w_sp = 1, w
        elif self.idx == 1:
            h_sp, w_sp = h, 1
        else:
            h_sp = w_sp = self.split_size
        nh = self.num_heads
        hd = c // nh
        scale = hd ** -0.5

        def heads(t):
            s = _stripes(t, h_sp, w_sp)  # (B', L, C)
            return s.reshape(s.shape[0], s.shape[1], nh, hd)

        qs, ks, vs = heads(q) * scale, heads(k), heads(v)
        attn = torch.einsum("blhd,bmhd->bhlm", qs, ks)

        if pos is not None:
            # pairwise displacement within one stripe -> per-head bias
            p = _stripes(pos[None], h_sp, w_sp)[..., :2]  # (nWin, L, 2)
            rel = p[:, :, None, :] - p[:, None, :, :]     # (nWin, L, L, 2)
            e = self.pos_fc2(torch.relu(self.pos_ln(self.pos_fc1(rel))))
            bias = e.permute(0, 3, 1, 2)                   # (nWin, nh, L, L)
            n_win, ll = bias.shape[0], attn.shape[-1]
            attn = (attn.reshape(b, n_win, nh, ll, ll) + bias[None]).reshape(
                b * n_win, nh, ll, ll)

        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", attn, vs)
        out = out.reshape(out.shape[0], out.shape[1], c)
        return _unstripes(out, h_sp, w_sp, h, w)


class CSWinBlock(nn.Module):
    """Pre-norm CSWin block: qkv projection, two half-channel stripe
    branches (rows ``attn_row``, columns ``attn_col``; one square-window
    ``attn`` when ``last_stage``), channel concat, output projection, MLP,
    both residual. ``pos`` builds the branches' position MLPs."""

    def __init__(self, dim, num_heads, split_size=7, mlp_ratio=4.0,
                 last_stage=False, pos=True):
        super().__init__()
        self.last_stage = last_stage
        self.norm1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, use_bias=False)
        if last_stage:
            self.attn = LePEAttention(-1, num_heads, split_size, pos)
        else:
            self.attn_row = LePEAttention(0, num_heads // 2, split_size, pos)
            self.attn_col = LePEAttention(1, num_heads // 2, split_size, pos)
        self.proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, pos=None):
        """x: (B, H, W, C); pos: (H, W, 2) or None."""
        c = x.shape[-1]
        q, k, v = torch.chunk(self.qkv(self.norm1(x)), 3, dim=-1)
        if self.last_stage:
            attn = self.attn(q, k, v, pos)
        else:
            half = c // 2
            attn = torch.cat([
                self.attn_row(q[..., :half], k[..., :half], v[..., :half],
                              pos),
                self.attn_col(q[..., half:], k[..., half:], v[..., half:],
                              pos)], dim=-1)
        x = x + self.proj(attn)
        return x + self.mlp(self.norm2(x))
