"""Vote-conditioned Swin window attention (counterpart of
``partner_tpu/models/swin_vote.py``).

- patch embed 1x1 conv in_ch -> embed_dim + LayerNorm;
- ``depth`` SwinVoteBlocks, window ``ws``, alternating shift 0 / ws//2 with
  the standard Swin region-id mask;
- WindowAttention: cosine attention with a per-head temperature tau
  (clamped >= 0.01), a vote embedding MLP(3 -> 16 -> C) added to q, k and
  v, and a relative-position-bias MLP(2 -> 16 -> heads) over pairwise
  cartesian deltas inside the window;
- final LayerNorm. Feature maps are NHWC (B, H=azimuth, W=range, C).

Two routes, as in the JAX package:

- per block (the default): LayerNorm, window partition and the MLP in
  torch, the attention core through :func:`ops.swin_attn.swin_vote_attention`.
  A map that does not tile into whole windows is padded to them, and its
  pad keys are masked in the plain attention (the JAX package runs its
  attention kernel only where no pad mask exists);
- whole block (``SwinVoteTransformer(use_block_kernel=True)``): each block
  is one call of :func:`ops.swin_block.swin_vote_block`, with the shift
  realized by rolls around it. A map that does not tile takes the per-block
  route, as in JAX.

Each op is the CUDA kernel for CUDA tensors and its plain twin for CPU
tensors. In train mode neither kernel runs, as JAX gates both on
``deterministic``: the whole-block route falls through to the per-block
modules, and ``WindowAttention`` takes the plain attention with
pre-normalized q and k (``swin_vote.py:182-245``). The head's dropout
rates are 0 in the JAX package (``E2ESWVoteHead`` never sets them), so it
has no dropout sites.

The static-RPE cache (``swin_vote.py:125-228``): at inference the RPE bias
is a function of the frozen RPE MLP and the window positions, the fixed
cell-center grid, so one fill pass
(:meth:`models.detectors.E2EDetector.prepare_inference`) stores each
per-block attention's (nW, nh, T, T) table, region mask folded in, and
later eval frames add it in the plain attention instead of rebuilding it.
The fill pass and the cached frames take the plain attention, never the
attention kernel, as JAX's cached branch never takes its Pallas kernel;
the whole-block route neither fills nor reads the cache, as in JAX.
``load_state_dict`` and ``train()`` drop the tables, which the old weights
built.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import swin_attn, swin_block
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


def pad_key_mask(h, w, ws, shift):
    """(num_windows, T) numpy bool, True where a window token is a cell of
    the h x w map and False where it is padding up to whole ws x ws
    windows, rolled like the padded map; None when the map tiles."""
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    if (hp, wp) == (h, w):
        return None
    valid = np.zeros((hp, wp), bool)
    valid[:h, :w] = True
    valid = np.roll(valid, (-shift, -shift), axis=(0, 1))
    return (valid.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
            .reshape(-1, ws * ws))


def _drop_rpe_table(module, *args):
    """load_state_dict pre-hook: the table was built from the old weights."""
    module.rpe_table = None


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
        # the static-RPE cache: (nW, nh, T, T) f32 with the region mask
        # folded in, or None; out of the state_dict, like JAX's rpe_cache
        # collection, which no checkpoint holds. JAX's cache travels with
        # its variables, so new weights come without it; here loading
        # weights or going back to training drops the table.
        self.register_buffer("rpe_table", None, persistent=False)
        self.rpe_fill = False   # the next eval forward stores rpe_table
        self.register_load_state_dict_pre_hook(_drop_rpe_table)

    def init_extra(self, generator):
        self.tau.data.fill_(1.0)

    def train(self, mode=True):
        if mode:
            self.rpe_table = None
        return super().train(mode)

    def forward(self, x, pos, vote, mask=None, pad_mask=None,
                num_windows=None):
        """x (nB, T, C); pos (nB, T, 2) f32; vote (nB, T, 3); mask
        (nW, T, T) f32 or None, window w taking mask[w % nW]; pad_mask
        (nW, T) bool (True = real cell) or None, tiled the same way;
        num_windows, the windows of one sample (the fill pass's nW where
        there is no mask). Train mode or a pad mask takes the plain
        attention, as in the JAX package; so do the static-RPE fill pass
        and the frames that read its table; otherwise the attention op
        (kernel or twin) runs."""
        nb, t, c = x.shape
        nh = self.num_heads
        hd = c // nh
        dt = self.dtype
        ve = self.vote_mlp(vote.to(dt)).reshape(nb, t, nh, hd).transpose(1, 2)
        qkv = self.qkv(x.to(dt)).reshape(nb, t, 3, nh, hd).permute(
            2, 0, 3, 1, 4)
        q, k, v = ((qkv[i] + ve).contiguous() for i in range(3))
        rp = self.rpe
        cache_ok = pad_mask is None and not self.training
        if cache_ok and self.rpe_fill:
            rpe = self._rpe(pos)
            nw = mask.shape[0] if mask is not None else num_windows
            if nw is None:
                raise ValueError("the static-RPE fill of an unshifted block "
                                 "needs num_windows")
            self.rpe_table = (rpe[:nw] if mask is None
                              else rpe[:nw] + mask[:, None])
            out = self._plain_attention(q, k, v, rpe, mask, None)
        elif cache_ok and self.rpe_table is not None:
            out = self._plain_attention(q, k, v, self.rpe_table, None, None)
        elif cache_ok:
            out = swin_attn.swin_vote_attention(
                q, k, v, pos.float().contiguous(), mask,
                rp.Dense_0.weight.t().float().contiguous(),
                rp.Dense_0.bias.float().contiguous(),
                rp.Dense_1.weight.t().float().contiguous(),
                rp.Dense_1.bias.float().contiguous(),
                torch.clamp(self.tau, min=0.01).reshape(nh).contiguous())
        else:
            out = self._plain_attention(q, k, v, self._rpe(pos), mask,
                                        pad_mask)
        return self.proj(out.transpose(1, 2).reshape(nb, t, c))

    def _rpe(self, pos):
        """The decomposed RPE bias of the windows, (nB, nh, T, T) f32."""
        rp = self.rpe
        return swin_block.rpe_bias(
            pos, (rp.Dense_0.weight.t(), rp.Dense_0.bias,
                  rp.Dense_1.weight.t(), rp.Dense_1.bias), self.dtype)

    def _plain_attention(self, q, k, v, bias, mask, pad_mask):
        """The JAX package's plain attention (``swin_vote.py:182-245``):
        q / (|q| tau) and k / |k| rounded to the compute dtype, f32 logits,
        + ``bias`` (the RPE of every window, or a cached (nW, nh, T, T)
        table tiled over the batch), + the region mask, pad keys (if any)
        set to -100, softmax, ``P.V`` with f32 accumulation."""
        nb, nh, t, _ = q.shape
        dt = self.dtype
        qf, kf = q.float(), k.float()
        qn = torch.sqrt((qf * qf).sum(-1, keepdim=True) + 1e-12)
        kn = torch.sqrt((kf * kf).sum(-1, keepdim=True) + 1e-12)
        qh = (qf / (qn * torch.clamp(self.tau, min=0.01))).to(dt)
        kh = (kf / kn).to(dt)
        attn = qh.float() @ kh.float().transpose(-1, -2)
        nwb = bias.shape[0]
        attn = (attn.reshape(nb // nwb, nwb, nh, t, t)
                + bias[None]).reshape(nb, nh, t, t)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(nb // nw, nw, nh, t, t)
                    + mask[None, :, None]).reshape(nb, nh, t, t)
        if pad_mask is not None:
            nw = pad_mask.shape[0]
            attn = torch.where(pad_mask[None, :, None, None, :],
                               attn.reshape(nb // nw, nw, nh, t, t), -100.0)
        attn = torch.softmax(attn.reshape(nb, nh, t, t), dim=-1).to(dt)
        return (attn.float() @ v.float()).to(dt)


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
        """The per-block route; a map that does not tile is padded to
        whole windows (``swin_vote.py:267-307``)."""
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        shortcut = x
        x = self.norm1(x)
        if (hp, wp) != (h, w):
            x, pos, vote = (F.pad(t, (0, 0, 0, wp - w, 0, hp - h))
                            for t in (x, pos, vote))
        if shift:
            x, pos, vote = (torch.roll(t, (-shift, -shift), dims=(1, 2))
                            for t in (x, pos, vote))
        dev = x.device
        mask = constant(self, f"mask{hp}x{wp}", dev,
                        lambda: swin_attn_mask(hp, wp, ws, shift))
        pad_mask = constant(self, f"pad{h}x{w}", dev,
                            lambda: pad_key_mask(h, w, ws, shift))
        out = self.attn(window_partition(x, ws), window_partition(pos, ws),
                        window_partition(vote, ws), mask, pad_mask,
                        num_windows=(hp // ws) * (wp // ws))
        out = window_reverse(out, ws, b, hp, wp)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = shortcut + out[:, :h, :w].float()
        y = self.mlp_fc1(self.norm2(x).to(self.dtype))
        y = self.mlp_fc2(gelu(y))
        return x + y.float()

    def whole_block(self, x, pos, vote):
        """The whole-block route (``swin_vote.py:368-394``) on a map that
        tiles: pre-roll x, pos and vote for a shifted block, run the block
        op on the compute-dtype x, return it as f32, rolled back."""
        _, h, w, _ = x.shape
        ws, shift, dt = self.window_size, self.shift_size, self.dtype
        if shift:
            x, pos, vote = (torch.roll(t, (-shift, -shift), dims=(1, 2))
                            for t in (x, pos, vote))
        mask = constant(self, f"mask{h}x{w}", x.device,
                        lambda: swin_attn_mask(h, w, ws, shift))
        params = swin_block.swin_vote_block_params(self, dt)
        bias = swin_block.block_bias_table(pos, mask, params["rpe"], dt, ws)
        y = swin_block.swin_vote_block(
            x.to(dt).contiguous(), vote.float().contiguous(), bias, params,
            self.attn.num_heads, ws).float()
        return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y


class SwinVoteTransformer(nn.Module):
    """SwVoteHeadV4: patch-embed + depth blocks + final LayerNorm.

    ``use_block_kernel`` selects the whole-block route (the JAX module's
    ``use_block_kernel`` field, without its environment-variable gate) at
    inference; train mode always runs the per-block modules."""

    def __init__(self, in_channels, embed_dim=256, depth=2, num_heads=4,
                 window_size=7, mlp_ratio=1.0, compute_dtype="float32",
                 use_block_kernel=False):
        super().__init__()
        dt = resolve_compute_dtype(compute_dtype)
        self.depth = depth
        self.window_size = window_size
        self.use_block_kernel = use_block_kernel
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
        ws = self.window_size
        whole = (self.use_block_kernel and not self.training
                 and x.shape[1] % ws == 0 and x.shape[2] % ws == 0)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if whole:
                x = block.whole_block(x, pos, vote)
            else:
                x = block(x, pos, vote)
        return self.norm_out(x)
