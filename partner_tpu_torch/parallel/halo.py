"""Azimuth-ring halo exchange for sector-sharded BEV maps (counterpart of
``partner_tpu/parallel/halo.py``).

Each rank of an azimuth group holds a contiguous run of a sweep's azimuth
rows, in rank order. JAX's ``lax.ppermute`` around the ring becomes
:func:`shift`: a ``batch_isend_irecv`` to the next (or previous) rank
inside an autograd Function whose backward is the opposite shift, so each
halo's cotangent travels back to the rank whose rows it padded. Every rank
takes part in every shift, the first rank of :func:`trailing_halo` too
(its zeroed halo sends a zero cotangent back), so no rank waits on a
neighbour that skipped one.

A module names its group as JAX names its mesh axis: ``RPNHalo(axis_name=
"azimuth")`` reads the group :func:`set_axis_group` registered under that
name; an unregistered name raises, as an unbound axis name does in JAX.
"""

import torch
import torch.distributed as tdist

from . import dist

_axes = {}


def set_axis_group(name, group):
    """Register ``group`` (a process group of the azimuth shards, in ring
    order; None removes it) under the axis ``name``."""
    if group is None:
        _axes.pop(name, None)
    else:
        _axes[name] = group


def axis_group(name):
    """The group registered under ``name``."""
    if name not in _axes:
        raise NameError(f"unbound axis name {name!r}: register its process "
                        "group with parallel.halo.set_axis_group")
    return _axes[name]


def _send_along(t, group, step):
    """Send ``t`` to the rank ``step`` places on around the ring and
    return what the rank ``step`` places back sent."""
    n = tdist.get_world_size(group)
    if n == 1:
        return t.clone()
    r = tdist.get_rank(group)
    dst = tdist.get_global_rank(group, (r + step) % n)
    src = tdist.get_global_rank(group, (r - step) % n)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.counts["collectives"] += 1
    ops = [tdist.P2POp(tdist.isend, t, dst, group),
           tdist.P2POp(tdist.irecv, out, src, group)]
    for w in tdist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, step):
        ctx.group, ctx.step = group, step
        return _send_along(t, group, step)

    @staticmethod
    def backward(ctx, g):
        return _send_along(g, ctx.group, -ctx.step), None, None


def shift(t, group, step=1):
    """Rank r's ``t`` -> rank r + step (cyclic); autograd sends the
    cotangent the other way."""
    return _Shift.apply(t, group, step)


def _group(group):
    return axis_group(group) if isinstance(group, str) else group


def ring_halo(x, pad, group=None, axis=1):
    """Cyclic bidirectional halo: the previous shard's trailing ``pad``
    rows prepended and the next shard's leading rows appended along
    ``axis``. ``group``: the azimuth process group (or its registered axis
    name); None, or a group of one, is circular padding."""
    lead = x.narrow(axis, 0, pad)
    trail = x.narrow(axis, x.shape[axis] - pad, pad)
    if group is None:
        return torch.cat([trail, x, lead], dim=axis)
    g = _group(group)
    return torch.cat([shift(trail, g, 1), x, shift(lead, g, -1)], dim=axis)


def trailing_halo(x, pad, group=None, axis=1):
    """One-directional halo: the previous shard's trailing rows prepended
    (zeros on shard 0, ConvContext's first-sector zero padding) and ``pad``
    zero rows appended. With no group, or a group of one, the rows
    prepended are zeros."""
    trail = x.narrow(axis, x.shape[axis] - pad, pad)
    tail = torch.zeros_like(trail)
    if group is None:
        return torch.cat([tail, x, tail], dim=axis)
    g = _group(group)
    prev = shift(trail, g, 1)
    first = torch.tensor(tdist.get_rank(g) == 0, device=x.device)
    prev = torch.where(first, torch.zeros_like(prev), prev)
    return torch.cat([prev, x, tail], dim=axis)
