"""Shared building blocks (counterpart of ``partner_tpu/models/layers.py``).

Conventions carried over from flax so converted weights compute the same
function:

- ``Dense``/``Conv2d``/``ConvTranspose2d`` keep their parameters in float32
  and cast input and parameters to their compute ``dtype`` at the call, as
  a flax layer with ``dtype=`` does. A bf16 product accumulates in f32 and
  rounds once to bf16 on the way out.
- Convolutions take and return NHWC tensors. Inside they run on the NCHW
  view of the same memory (channels-last for cuDNN), so no copy is made.
- ``BatchNorm`` is the inference affine over the last axis, computed in
  float32 with flax's operation order; its eps is explicit at every call
  site (1e-3 for the conv trunks, 1e-5 for the head and pos-embed stacks).
- ``LayerNorm`` uses flax's eps of 1e-6 (torch's default is 1e-5).
- GELU is the tanh approximation (flax ``approximate=True``).

The port runs inference only: Dropout and DropPath are the identity there
and are left out; BatchNorm always uses its running statistics.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3       # conv trunks, stem and RPN (flax BatchNorm momentum 0.99)
POS_BN_EPS = 1e-5   # pos-embed stacks (torch BatchNorm1d defaults)
LN_EPS = 1e-6       # flax nn.LayerNorm default


def LayerNorm(features):
    return nn.LayerNorm(features, eps=LN_EPS)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def constant(module, name, device, make):
    """A constant array of a module's shapes (a region mask, a cell grid)
    as a tensor on ``device``, built by ``make()`` (numpy or None) once per
    device. The JAX package's jitted frame holds these as compile-time
    constants; an eager frame would otherwise rebuild them and copy them
    to the card, waiting for it, every frame."""
    cache = module.__dict__.setdefault("_constants", {})
    key = (name, str(device))
    if key not in cache:
        arr = make()
        cache[key] = None if arr is None else torch.as_tensor(arr,
                                                              device=device)
    return cache[key]


def _empty(*shape):
    return nn.Parameter(torch.empty(*shape))


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ W^T + b in ``dtype`` (torch Linear layout)."""

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty(out_features, in_features)
        self.bias = _empty(out_features) if use_bias else None

    def fan_in(self):
        return self.weight.shape[1]

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def same_pads(size, k, s):
    """XLA "SAME" padding (before, after) for one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NHWC tensors; ``padding`` is "SAME" or an int.

    "SAME" follows XLA: for a stride-2 3x3 conv on an even input it pads 0
    before and 1 after, which torch's symmetric ``padding=1`` does not."""

    def __init__(self, in_features, out_features, kernel, stride=1,
                 padding="SAME", use_bias=True, dtype=torch.float32,
                 init_bias=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.init_bias = init_bias
        self.weight = _empty(out_features, in_features, kernel, kernel)
        self.bias = _empty(out_features) if use_bias else None

    def fan_in(self):
        return math.prod(self.weight.shape[1:])

    def forward(self, x):
        dt = self.dtype
        k = self.weight.shape[-1]
        x = x.permute(0, 3, 1, 2).to(dt)
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], k, self.stride)
            pw = same_pads(x.shape[3], k, self.stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                pad = 0
        else:
            pad = int(self.padding)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x, self.weight.to(dt), b, self.stride, pad)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose`` (padding "SAME") with kernel == stride, on
    NHWC tensors; weight in torch's (I, O, kh, kw) layout, i.e. the flax
    kernel flipped spatially (see convert.py)."""

    def __init__(self, in_features, out_features, stride,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.weight = _empty(in_features, out_features, stride, stride)

    def fan_in(self):
        w = self.weight
        return w.shape[0] * w.shape[2] * w.shape[3]

    def forward(self, x):
        dt = self.dtype
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt),
                               self.weight.to(dt), None, self.stride)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis, float32 out.

    Same operation order as flax's ``_normalize``:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features, eps):
        super().__init__()
        self.eps = eps
        self.weight = _empty(features)
        self.bias = _empty(features)
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x.float() - self.running_mean) * mul + self.bias


class Mlp(nn.Module):
    """Transformer MLP fc -> tanh-GELU -> fc (dropout is inference identity)."""

    def __init__(self, features, hidden, out, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(features, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.Dense_1(gelu(self.Dense_0(x)))


class PosEmbedMLP(nn.Module):
    """Relative-position bias MLP 2 -> hidden -> BN -> ReLU -> num_heads.

    At inference it is only ever applied through
    :func:`decompose_pos_mlp`, as in the JAX package."""

    def __init__(self, num_heads, hidden=16, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(2, hidden, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(hidden, POS_BN_EPS)
        self.Dense_1 = Dense(hidden, num_heads, dtype=dtype)


def decompose_pos_mlp(mlp, dt):
    """Split a :class:`PosEmbedMLP` into per-token / per-pair parts.

    ``bias == finish(proj(pos_a) - proj(pos_b))``: the first Dense and the
    inference BN are one linear map, so it runs per token. ``proj`` stays
    float32 (positions reach ~75 m, where a bf16 ulp is 0.5); ``finish``
    adds the folded bias in float32 and casts to ``dt`` only then."""
    f32 = torch.float32
    bn = mlp.BatchNorm_0
    w0 = mlp.Dense_0.weight.t().to(f32)
    b0 = mlp.Dense_0.bias.to(f32)
    a = bn.weight / torch.sqrt(bn.running_var + POS_BN_EPS)
    w0 = w0 * a[None, :]
    b0 = b0 * a + bn.bias - bn.running_mean * a
    w1 = mlp.Dense_1.weight.t().to(dt)
    b1 = mlp.Dense_1.bias.to(dt)

    def proj(pos):
        return pos.to(f32) @ w0

    def finish(h):
        return torch.relu((h + b0).to(dt)) @ w1 + b1

    return proj, finish


# ---------------------------------------------------------------- init

def _lecun_normal_(p, fan_in, generator):
    """flax ``lecun_normal``: truncated normal (2 std), variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(p.shape)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    with torch.no_grad():
        p.copy_(t)


@torch.no_grad()
def init_weights(module, generator):
    """Fill every parameter and buffer of ``module`` with flax's default
    initializers, drawing from ``generator`` (a CPU ``torch.Generator``).

    Kernels are lecun-normal, biases zero (or a layer's ``init_bias``),
    norm scales one, BN statistics (0, 1); modules with raw parameters
    provide ``init_extra(generator)``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv2d, ConvTranspose2d)):
            _lecun_normal_(m.weight, m.fan_in(), generator)
            if getattr(m, "bias", None) is not None:
                m.bias.fill_(getattr(m, "init_bias", None) or 0.0)
        elif isinstance(m, (BatchNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, BatchNorm):
                m.running_mean.fill_(0.0)
                m.running_var.fill_(1.0)
        if hasattr(m, "init_extra"):
            m.init_extra(generator)
