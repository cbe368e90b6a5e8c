"""Shared building blocks (counterpart of ``partner_tpu/models/layers.py``).

Conventions carried over from flax so converted weights compute the same
function:

- ``Dense``/``Conv2d``/``Conv3d``/``ConvTranspose2d`` keep their
  parameters in float32 and cast input and parameters to their compute
  ``dtype`` at the call, as a flax layer with ``dtype=`` does. A bf16 product accumulates in f32 and
  rounds once to bf16 on the way out.
- Convolutions take and return NHWC (NDHWC) tensors. Inside they run on the
  NCHW (NCDHW) view of the same memory (channels-last for cuDNN), so no
  copy is made.
- ``BatchNorm`` normalizes over the last axis in float32 with flax's
  operation order; its eps and momentum are explicit at every call site
  (1e-3 and 0.99 for the conv trunks, stem and RPN; 1e-5 and 0.9 for the
  head and pos-embed stacks). In train mode it uses flax's batch
  statistics and running update, not ``nn.BatchNorm*``'s.
- ``LayerNorm`` uses flax's eps of 1e-6 (torch's default is 1e-5).
- GELU is the tanh approximation (flax ``approximate=True``).
- ``Dropout`` and ``DropPath`` are the identity in eval mode; in train mode
  they draw from a ``torch.Generator`` that the caller passes down the
  forward, as flax draws from the ``dropout`` rng.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3       # conv trunks, stem and RPN
BN_MOMENTUM = 0.99  # their flax momentum (the retained fraction)
POS_BN_EPS = 1e-5   # pos-embed stacks (torch BatchNorm1d defaults)
POS_BN_MOMENTUM = 0.9
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


class Conv3d(nn.Module):
    """flax ``nn.Conv`` with a 3D kernel on NDHWC tensors, no bias;
    ``padding`` is "SAME" (XLA's, per axis) or "VALID"."""

    def __init__(self, in_features, out_features, kernel, stride=(1, 1, 1),
                 padding="SAME", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = tuple(stride)
        self.padding = padding
        self.weight = _empty(out_features, in_features, *kernel)

    def fan_in(self):
        return math.prod(self.weight.shape[1:])

    def forward(self, x):
        dt = self.dtype
        x = x.permute(0, 4, 1, 2, 3).to(dt)
        pad = 0
        if self.padding == "SAME":
            pads = [same_pads(x.shape[2 + i], self.weight.shape[2 + i],
                              self.stride[i]) for i in range(3)]
            if all(a == b for a, b in pads):
                pad = tuple(a for a, _ in pads)
            else:
                x = F.pad(x, [v for p in pads[::-1] for v in p])
        y = F.conv3d(x, self.weight.to(dt), None, self.stride, pad)
        return y.permute(0, 2, 3, 4, 1)


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
    """BatchNorm over the last axis, float32 out.

    Same operation order as flax's ``_normalize``:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. In eval mode mean
    and var are the running statistics. In train mode they are the batch's,
    in float32 over every axis but the last, the variance biased and taken
    as flax takes it (``max(E[x^2] - E[x]^2, 0)``); the running statistics
    then move to ``momentum * old + (1 - momentum) * batch``."""

    def __init__(self, features, eps, momentum):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = _empty(features)
        self.bias = _empty(features)
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, var = batch_stats(xf, tuple(range(x.dim() - 1)))
            update_running(self.running_mean, mean, self.momentum)
            update_running(self.running_var, var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


def batch_stats(xf, dims):
    """flax's train-mode statistics of float32 ``xf`` over ``dims``: the
    mean and ``max(E[x^2] - E[x]^2, 0)``, the biased variance."""
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    return mean, var


@torch.no_grad()
def update_running(stat, batch, momentum):
    """flax's running update, in place: ``momentum * stat + (1 - momentum)
    * batch``."""
    stat.copy_(momentum * stat + (1.0 - momentum) * batch)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``; the identity in eval mode or at
    rate 0. Draws from the generator passed to ``forward``."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = _uniform(x.shape, generator, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch (``layers.py:126-139``): one
    Bernoulli draw per sample with keep probability ``1 - rate``, then
    ``x * mask / keep``; the identity in eval mode or at rate 0. Draws from
    the generator passed to ``forward``."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = _uniform(shape, generator, x.device) < keep
        return x * mask / keep


def _uniform(shape, generator, device):
    """Uniform [0, 1) draws from ``generator`` on its own device, moved to
    ``device``: a CPU generator gives the same masks to a CPU and a CUDA
    run."""
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u.to(device)


class Mlp(nn.Module):
    """Transformer MLP fc -> tanh-GELU -> dropout -> fc -> dropout."""

    def __init__(self, features, hidden, out, drop=0.0, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(features, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, out, dtype=dtype)
        self.drop = Dropout(drop)

    def forward(self, x, generator=None):
        x = self.drop(gelu(self.Dense_0(x)), generator)
        return self.drop(self.Dense_1(x), generator)


class PosEmbedMLP(nn.Module):
    """Relative-position bias MLP 2 -> hidden -> BN -> ReLU -> num_heads.

    At inference it is applied through :func:`decompose_pos_mlp`; in train
    mode directly on the pair tensor, its BN taking the pair tensor's batch
    statistics, as in the JAX package."""

    def __init__(self, num_heads, hidden=16, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(2, hidden, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(hidden, POS_BN_EPS, POS_BN_MOMENTUM)
        self.Dense_1 = Dense(hidden, num_heads, dtype=dtype)

    def forward(self, rel):
        h = self.BatchNorm_0(self.Dense_0(rel)).to(self.dtype)
        return self.Dense_1(torch.relu(h))


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
        if isinstance(m, (Dense, Conv2d, Conv3d, ConvTranspose2d)):
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
