"""Whole-block fused SwinVote transformer block: CUDA kernel and its plain
PyTorch twin.

Counterpart of ``partner_tpu/ops/swin_block_pallas.py:swin_vote_block``.
One SwinVote block over inputs that tile exactly into ws x ws windows
(shifted blocks are pre-rolled by the caller, and their region mask is
folded into the bias table):

  LN1 -> qkv (+ vote-MLP embed) -> cosine window attention (1/tau folded
  into q) + RPE/region bias table -> per-head proj sum -> residual ->
  LN2 -> MLP (tanh GELU) -> residual

with the TPU kernel's cast points, which are not those of the per-block
route (``models/swin_vote.py:SwinVoteBlock``): the residual stream is
f32 inside the block and rounded to the compute dtype at its input and
output; the vote MLP runs in f32; the qkv bias is added in f32 after f32
accumulation; ``q * (1/tau / |q|)`` and ``k / |k|`` are rounded to the
compute dtype before the logits; ``P`` and ``v`` are rounded before
``P.V`` (f32 accumulation), each head's output before the proj, and the
proj is an f32 sum over heads plus an f32 bias; LayerNorm eps is 1e-6.

The RPE/region bias table is built outside the kernel in plain torch, as
the JAX package builds it in XLA outside the Pallas call
(:func:`block_bias_table`).

:func:`swin_vote_block` launches ``csrc/swin_block.cu`` for CUDA tensors
and runs :func:`swin_vote_block_plain` for CPU tensors; there is no other
switch. ``swin_vote_block.launches`` counts kernel launches.
"""

import torch
import torch.nn.functional as F

from . import _cuda

# the shapes csrc/swin_block.cu is compiled for: channels, heads (of
# width 64), window, MLP hidden width, vote-MLP hidden width
C, NH, WS, MLP_HIDDEN, VOTE_HIDDEN = 256, 4, 8, 256, 16
LN_EPS = 1e-6


def _packed_shapes(c, nh, m, vh):
    """name -> (shape, is a compute-dtype operand) of the packed
    parameters, in the order the kernel's C entry point takes them; m is
    the MLP hidden width, vh the vote-MLP hidden width."""
    return {
        "ln1_scale": ((c,), False), "ln1_bias": ((c,), False),
        "qkv_w": ((3 * c, c), True), "qkv_b": ((3 * c,), False),
        "vote_w1": ((3, vh), False), "vote_b1": ((vh,), False),
        "vote_w2": ((vh, c), False), "vote_b2": ((c,), False),
        "itau": ((nh,), False),
        "proj_w": ((c, c), True), "proj_b": ((c,), False),
        "ln2_scale": ((c,), False), "ln2_bias": ((c,), False),
        "fc1_w": ((m, c), True), "fc1_b": ((m,), False),
        "fc2_w": ((c, m), True), "fc2_b": ((c,), False),
    }


def swin_vote_block_params(block, dtype):
    """Pack a port ``SwinVoteBlock``'s parameters for the block op, as
    ``SwinVoteTransformer._block_kernel_params`` gathers the flax block's.

    The qkv, proj and MLP weights are cast to ``dtype`` and keep torch's
    (out, in) layout, K contiguous, from which the CUDA kernel copies
    tiles of 64 K columns into shared memory; everything else is float32:
    the norms, every bias, the vote MLP (flax's (in, out) layout), ``itau
    = 1 / max(tau, 0.01)`` and, under ``"rpe"``, the RPE MLP for
    :func:`block_bias_table`."""
    a = block.attn
    f32 = torch.float32

    def w(dense):
        return dense.weight.detach().to(dtype).contiguous()

    def f(t):
        return t.detach().to(f32).contiguous()

    vm, rp = a.vote_mlp, a.rpe
    return {
        "ln1_scale": f(block.norm1.weight), "ln1_bias": f(block.norm1.bias),
        "qkv_w": w(a.qkv), "qkv_b": f(a.qkv.bias),
        "vote_w1": f(vm.Dense_0.weight.t()), "vote_b1": f(vm.Dense_0.bias),
        "vote_w2": f(vm.Dense_1.weight.t()), "vote_b2": f(vm.Dense_1.bias),
        "itau": f(1.0 / torch.clamp(a.tau.detach().float().reshape(-1),
                                     min=0.01)),
        "proj_w": w(a.proj), "proj_b": f(a.proj.bias),
        "ln2_scale": f(block.norm2.weight), "ln2_bias": f(block.norm2.bias),
        "fc1_w": w(block.mlp_fc1), "fc1_b": f(block.mlp_fc1.bias),
        "fc2_w": w(block.mlp_fc2), "fc2_b": f(block.mlp_fc2.bias),
        "rpe": (f(rp.Dense_0.weight.t()), f(rp.Dense_0.bias),
                f(rp.Dense_1.weight.t()), f(rp.Dense_1.bias)),
    }


def rpe_bias(pos, rpe, dtype):
    """RPE logit bias of windows of positions, in the JAX package's
    decomposed form: layer 1 is linear over the pair difference, so
    ``(pos_i - pos_j) @ W0 == u_i - u_j`` with ``u = pos @ W0`` per token.

    ``u`` and the subtract stay float32 (positions reach ~75 m, where a
    bf16 ulp is 0.5 m); ``u`` is the two-term product written out, a true
    float32 product whatever the TF32 settings. Then ``+ b0``, the cast to
    ``dtype``, ReLU, ``@ W1 + b1`` in ``dtype``, back to float32.

    Args:
      pos: (..., T, 2) window cell positions.
      rpe: (W0 (2, hid), b0 (hid,), W1 (hid, nh), b1 (nh,)) RPE MLP.
    Returns (..., nh, T, T) float32.
    """
    w0, b0, w1, b1 = rpe
    f32 = torch.float32
    pos = pos.to(f32)
    w0 = w0.to(f32)
    u = pos[..., 0:1] * w0[0] + pos[..., 1:2] * w0[1]          # (..., T, hid)
    hid = torch.relu((u[..., :, None, :] - u[..., None, :, :]
                      + b0.to(f32)).to(dtype))                # (..., T, T, hid)
    out = (hid @ w1.to(dtype) + b1.to(dtype)).to(f32)         # (..., T, T, nh)
    return out.movedim(-1, -3)


def block_bias_table(pos, mask, rpe, dtype, ws):
    """The block op's additive logit table, as the JAX package builds it
    outside the Pallas call (``swin_block_pallas.py:183-200``).

    Args:
      pos: (B, H, W, 2) cell positions, pre-rolled like x for shifted
        blocks; H and W multiples of ``ws``.
      mask: (nwy * nwx, T, T) float32 additive region mask ordered
        (wy, wx), or None for unshifted blocks.
      rpe: the RPE MLP, as :func:`rpe_bias` takes it.
      dtype: the compute dtype of the RPE MLP's second layer.
    Returns (B, nwy, nwx, nh, T, T) float32, contiguous.
    """
    b, h, w, _ = pos.shape
    nwy, nwx, t = h // ws, w // ws, ws * ws
    pw = (pos.to(torch.float32).reshape(b, nwy, ws, nwx, ws, 2)
          .permute(0, 1, 3, 2, 4, 5).reshape(b, nwy, nwx, t, 2))
    bias = rpe_bias(pw, rpe, dtype)
    if mask is not None:
        bias = bias + mask.to(torch.float32).reshape(nwy, nwx, 1, t, t)
    return bias.contiguous()


def _layer_norm(x, scale, bias):
    """The TPU kernel's f32 LayerNorm: two-pass variance, eps 1e-6."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS) * scale + bias


def swin_vote_block_plain(x, vote, bias, params, nh, ws):
    """One SwinVote block in plain PyTorch, with the TPU kernel's casts.

    Every product takes compute-dtype operands and is computed in float32:
    products of bf16 values are exact in f32, so this is the f32-
    accumulated product of the kernel (with TF32 off on the card).

    Args:
      x: (B, H, W, C) block input in the compute dtype (pre-rolled).
      vote: (B, H, W, 3) vote features (pre-rolled).
      bias: (B, nwy, nwx, nh, T, T) float32 from :func:`block_bias_table`.
      params: from :func:`swin_vote_block_params`.
    Returns (B, H, W, C) block output in x.dtype.
    """
    b, hh, ww, c = x.shape
    dt = x.dtype
    nwy, nwx, t, hd = hh // ws, ww // ws, ws * ws, c // nh
    p = {k: v.float() for k, v in params.items() if k != "rpe"}

    def rounded(a):
        return a.to(dt).float()

    def windows(a):   # (B, H, W, ch) -> (nW, T, ch), window-major tokens
        return (a.reshape(b, nwy, ws, nwx, ws, -1).permute(0, 1, 3, 2, 4, 5)
                .reshape(b * nwy * nwx, t, -1))

    xw = windows(x.float())
    y = rounded(_layer_norm(xw, p["ln1_scale"], p["ln1_bias"]))
    vh = torch.relu(windows(vote.float()) @ p["vote_w1"] + p["vote_b1"])
    ve = (vh @ p["vote_w2"] + p["vote_b2"]).reshape(-1, t, nh, hd)
    qkv = (y @ p["qkv_w"].t() + p["qkv_b"]).reshape(-1, t, 3, nh, hd)
    q, k, v = ((qkv[:, :, i] + ve).transpose(1, 2) for i in range(3))
    qn = torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = torch.sqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    qh = rounded(q * (p["itau"][:, None, None] / qn))
    kh = rounded(k / kn)
    logits = qh @ kh.transpose(-1, -2) + bias.float().reshape(-1, nh, t, t)
    logits = logits - logits.amax(-1, keepdim=True)
    e = torch.exp(logits)
    prob = e / e.sum(-1, keepdim=True)
    po = rounded(rounded(prob) @ rounded(v))                 # (nW, nh, T, hd)
    acc = po.transpose(1, 2).reshape(-1, t, c) @ p["proj_w"].t()
    x1 = xw + acc + p["proj_b"]
    y2 = rounded(_layer_norm(x1, p["ln2_scale"], p["ln2_bias"]))
    h1 = rounded(F.gelu(y2 @ p["fc1_w"].t() + p["fc1_b"], approximate="tanh"))
    out = (x1 + (h1 @ p["fc2_w"].t() + p["fc2_b"])).to(dt)
    return (out.reshape(b, nwy, nwx, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, hh, ww, c))


def swin_vote_block(x, vote, bias, params, nh, ws):
    """Fused SwinVote block: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors. Same arguments and result as
    :func:`swin_vote_block_plain`; the kernel takes a bf16 x with C = 256,
    nh = 4, hd = 64, ws = 8, an MLP hidden width of 256 and a vote-MLP
    hidden width of 16, and raises for anything else. Forward only: it
    raises when an input needs a gradient under grad mode."""
    _cuda.refuse_autograd(
        "swin_block", x, vote, bias,
        *(t for k, v in params.items()
          for t in (v if k == "rpe" else (v,))))
    if x.device.type == "cpu":
        return swin_vote_block_plain(x, vote, bias, params, nh, ws)
    req = _cuda.require
    req(x.device.type == "cuda", f"swin_block: unsupported device {x.device}")
    req(x.dim() == 4, f"swin_block: x must be (B, H, W, C), got {x.shape}")
    b, hh, ww, c = x.shape
    m, vh = params["fc1_w"].shape[0], params["vote_w1"].shape[-1]
    req((c, nh, ws, m, vh) == (C, NH, WS, MLP_HIDDEN, VOTE_HIDDEN),
        f"swin_block kernel is built for C, nh, ws, MLP hidden, vote hidden "
        f"= {C, NH, WS, MLP_HIDDEN, VOTE_HIDDEN}; got {c, nh, ws, m, vh}")
    req(hh % WS == 0 and ww % WS == 0,
        f"swin_block: map {hh}x{ww} does not tile into {WS}x{WS} windows")
    nwy, nwx, t = hh // WS, ww // WS, WS * WS
    f32, bf16 = torch.float32, torch.bfloat16
    args = [("x", x, bf16, (b, hh, ww, C)), ("vote", vote, f32, (b, hh, ww, 3)),
            ("bias", bias, f32, (b, nwy, nwx, NH, t, t))]
    for name, (shape, operand) in _packed_shapes(
            C, NH, MLP_HIDDEN, VOTE_HIDDEN).items():
        args.append((name, params[name], bf16 if operand else f32, shape))
    for name, a, dt, shape in args:
        req(a.device == x.device, f"swin_block: {name} on {a.device}")
        req(a.dtype == dt, f"swin_block: {name} must be {dt}, got {a.dtype}")
        req(tuple(a.shape) == shape,
            f"swin_block: {name} shape {tuple(a.shape)} != {shape}")
        req(a.is_contiguous(), f"swin_block: {name} must be contiguous")
        # the kernel copies rows of x, the weights and vote_w2 16 bytes at
        # a time
        req(a.data_ptr() % 16 == 0, f"swin_block: {name} must be 16-byte "
            "aligned")
    out = torch.empty_like(x)
    if b * nwy * nwx == 0:
        return out
    lib = _cuda.library().lib
    err = lib.ptt_swin_block_bf16(
        *(a.data_ptr() for _, a, _, _ in args), out.data_ptr(), b, nwy, nwx,
        _cuda.stream_ptr(x.device))
    _cuda.check(err, "swin_block")
    swin_vote_block.launches += 1
    return out


swin_vote_block.launches = 0
