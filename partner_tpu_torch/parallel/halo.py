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

The mesh's ``azimuth`` axis (``parallel.mesh``) shards the neck of
``VoxelNetV3`` and ``VoxelNet`` as XLA partitions it under JAX's
``bev_pspec``: :class:`AzimuthShard` keeps each rank's contiguous rows of
the BEV map (:meth:`~AzimuthShard.split`; the backward pads the other rows
with zeros), ``RPN`` runs on them with :func:`edge_halo` before each 3x3
conv (a neighbour's row on each side, zeros past the sweep's two ends, as
the unsharded conv's zero padding; not ``RPNHalo``'s ring), and
:meth:`~AzimuthShard.gather` all-gathers the neck's output for the heads
(the backward sums the cotangent over the group and keeps the rank's
rows).
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
    return dist.exchange(t, tdist.get_global_rank(group, (r + step) % n),
                         tdist.get_global_rank(group, (r - step) % n), group)


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


def _zeroed(t):
    """Zeros in ``t``'s place that keep ``t`` in the graph, so its shift's
    backward runs (and sends a zero cotangent) on this rank too."""
    keep = torch.ones((), dtype=torch.bool, device=t.device)
    return torch.where(keep, torch.zeros_like(t), t)


def edge_halo(x, before, after, group, axis=1):
    """The previous shard's trailing ``before`` rows prepended and the next
    shard's leading ``after`` rows appended along ``axis``, zeros past the
    first and the last shard (a conv's zero padding at the sweep's ends).
    Every rank takes part in every shift."""
    parts = [x]
    n, r = tdist.get_world_size(group), tdist.get_rank(group)
    if before:
        prev = shift(x.narrow(axis, x.shape[axis] - before, before), group, 1)
        parts.insert(0, _zeroed(prev) if r == 0 else prev)
    if after:
        nxt = shift(x.narrow(axis, 0, after), group, -1)
        parts.append(_zeroed(nxt) if r == n - 1 else nxt)
    return torch.cat(parts, dim=axis)


class AzimuthShard:
    """This rank's part of an azimuth-sharded neck: the ``azimuth`` group
    (ring order) and the ``neck`` group (data x azimuth) its BatchNorm
    statistics reduce over."""

    def __init__(self, group, neck_group):
        self.group = group
        self.neck_group = neck_group
        self.size = tdist.get_world_size(group)
        self.index = tdist.get_rank(group)

    def split(self, x, axis=1):
        """This rank's contiguous run of ``x``'s rows along ``axis``."""
        rows = x.shape[axis]
        if rows % self.size:
            raise ValueError(f"{rows} azimuth rows do not split over "
                             f"{self.size} ranks")
        n = rows // self.size
        return x.narrow(axis, self.index * n, n)

    def gather(self, x, axis=1):
        """Every rank's run, in order: the whole map."""
        return dist.cat_over(x, self.group, axis)
