"""What a run reads of the program, from the benchmark's own files:
spans of its layers as CUDA events recorded on the stream by forward
hooks and method wrappers, the inputs and outputs of its stages for the
check, its counters and hand kernels' launch counters, and, after a
traced run's window, a slice under ``torch.profiler``."""

import importlib
import time
from collections import defaultdict

import torch

def owner_and_name(root, path):
    """(object, attribute) that ``path`` names: a dotted path under
    ``root`` (``"det.module.neck"``), or ``"py:<module>:<function>"`` for
    a module-level function of the program."""
    if path.startswith("py:"):
        _, mod, attr = path.split(":")
        return importlib.import_module(mod), attr
    owner_path, _, attr = path.rpartition(".")
    owner = root
    for part in filter(None, owner_path.split(".")):
        owner = getattr(owner, part)
    return owner, attr


def resolve(root, path):
    """The object at ``path`` (:func:`owner_and_name`)."""
    owner, attr = owner_and_name(root, path)
    return getattr(owner, attr)


class _HostEvent:
    """A CUDA event's stand-in on a CPU run: the host clock."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class Spans:
    """Named spans of each frame or step: ``install`` hooks the program's
    layers (``{name: path}``, a module's forward or a function,
    :func:`owner_and_name`), ``mark`` brackets a part of the benchmark's
    own loop; a frame's spans count only between ``begin`` and ``end``.
    ``totals()`` -> ({name: ms summed over the kept frames}, kept
    frames)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.open = None      # this frame's [(name, start, end)] or None
        self.done = []
        self.stack = []

    def _event(self):
        ev = (torch.cuda.Event(enable_timing=True) if self.cuda
              else _HostEvent())
        ev.record()
        return ev

    def start(self, name):
        if self.open is not None:
            self.stack.append((name, self._event()))

    def stop(self, name):
        if self.open is not None and self.stack:
            n, ev = self.stack.pop()
            self.open.append((n, ev, self._event()))

    def mark(self, name):
        spans = self

        class _Mark:
            def __enter__(self):
                spans.start(name)

            def __exit__(self, *exc):
                spans.stop(name)
        return _Mark()

    def install(self, root, paths):
        for name, path in paths.items():
            owner, attr = owner_and_name(root, path)
            target = getattr(owner, attr)
            if isinstance(target, torch.nn.Module):
                target.register_forward_pre_hook(
                    lambda m, a, n=name: self.start(n))
                target.register_forward_hook(
                    lambda m, a, o, n=name: self.stop(n))
            else:
                setattr(owner, attr, self._wrapped(name, target))

    def _wrapped(self, name, fn):
        def call(*args, **kwargs):
            self.start(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.stop(name)
        return call

    def begin(self):
        self.open, self.stack = [], []

    def end(self):
        if self.open is not None:
            self.done.append(self.open)
        self.open = None

    def totals(self):
        if self.cuda:
            torch.cuda.synchronize()
        tot = defaultdict(float)
        for frame in self.done:
            for name, a, b in frame:
                tot[name] += a.elapsed_time(b)
        return dict(tot), len(self.done)


class Taps:
    """The inputs and output of each of the program's stages (``{name:
    path}``, a module's forward or a bound method), kept for the frames
    named in ``frames``: ``kept[frame][name] = (args, kwargs, output)``,
    cloned."""

    def __init__(self, frames):
        self.frames = set(frames)
        self.frame = None
        self.kept = {}

    def install(self, root, paths):
        for name, path in paths.items():
            owner, attr = owner_and_name(root, path)
            target = getattr(owner, attr)
            if isinstance(target, torch.nn.Module):
                target.register_forward_hook(
                    lambda m, a, k, o, n=name: self._keep(n, a, k, o),
                    with_kwargs=True)
            else:
                setattr(owner, attr, self._wrapped(name, target))

    def _wrapped(self, name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self._keep(name, args, kwargs, out)
            return out
        return call

    def _keep(self, name, args, kwargs, out):
        if self.frame in self.frames:
            self.kept.setdefault(self.frame, {})[name] = (
                clone_tree(args), clone_tree(kwargs), clone_tree(out))


def clone_tree(t):
    """A nest of tuples, lists and dicts with every tensor cloned."""
    if isinstance(t, torch.Tensor):
        return t.detach().clone()
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(clone_tree(v) for v in t)
    return t


class Kernels:
    """The launch counters of the program's hand-kernel wrappers (``{name:
    "module:function"}``): ``counts`` reads them, ``reset`` zeroes them."""

    def __init__(self, spec):
        self.spec = spec

    def _target(self, name):
        mod_name, fn = self.spec[name].split(":")
        return importlib.import_module(mod_name), fn

    def counts(self):
        out = {}
        for name in self.spec:
            mod, fn = self._target(name)
            out[name] = int(getattr(getattr(mod, fn), "launches", 0))
        return out

    def reset(self):
        for name in self.spec:
            mod, fn = self._target(name)
            getattr(mod, fn).launches = 0


class Counters:
    """The program's own counters (``{name: "module:attribute"}``, a
    module-level number the program adds to): ``reset`` sets each to 0,
    ``read`` gives each's value."""

    def __init__(self, spec):
        self.spec = dict(spec or {})

    def _target(self, name):
        mod_name, attr = self.spec[name].split(":")
        return importlib.import_module(mod_name), attr

    def reset(self):
        for name in self.spec:
            mod, attr = self._target(name)
            setattr(mod, attr, 0)

    def read(self):
        return {name: getattr(*self._target(name)) for name in self.spec}


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(host, a, b):
    """What the host was doing in the device's idle gap (a, b): the
    innermost host op spanning its middle, else the op it last finished."""
    mid = (a + b) / 2
    cover = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
    if cover:
        return min(cover, key=lambda e: e.time_range.end
                   - e.time_range.start).name
    before = [e for e in host if e.time_range.end <= mid]
    if before:
        return "after " + max(before, key=lambda e: e.time_range.end).name
    return "host"


def analyse(prof, window_s, items, top=10):
    """Readings of a profiled slice of ``items`` frames or steps that
    lasted ``window_s`` seconds on the host clock: {"busy_s", "window_s",
    "items", "launches" (kernels an item), "device_ops" [[name, s]] (most
    time first), "idle_gaps" [[host op, s]] (longest first)}."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    dev = [e for e in events if e.device_type == cuda]
    host = [e for e in events if e.device_type != cuda]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    spans = _union([[e.time_range.start, e.time_range.end] for e in dev])
    busy_us = sum(e - s for s, e in spans)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    device_ops = sorted(([n[:160], s] for n, s in by_name.items()),
                        key=lambda x: -x[1])[:top]
    gaps = sorted(([s0[1], s1[0]] for s0, s1 in zip(spans, spans[1:])),
                  key=lambda g: g[0] - g[1])[:top]
    idle = [[_label(host, a, b)[:160], (b - a) / 1e6] for a, b in gaps]
    return {"busy_s": busy_us / 1e6 if dev else None, "window_s": window_s,
            "items": items,
            "launches": len(kernels) / items if dev else None,
            "device_ops": device_ops, "idle_gaps": idle}


_warm = set()


def traced(step, count, device):
    """The readings of a traced run, after its window: ``torch.profiler``
    over ``count`` calls ``step(k)`` (one frame each), recording the host's
    ops beside the device's (for the idle gaps' labels) -> :func:`analyse`'s
    readings. The profiler slows the host (it records every op), so the
    slice's own length overstates the device's idle time; the device's
    busy seconds an item do not move. Its first use in a process loads its
    tracer (seconds): that happens on one call before the slice."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()
    if cuda not in _warm:
        with profile(activities=acts):
            step(0)
            sync()
        _warm.add(cuda)
    sync()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for k in range(count):
            step(k)
        sync()
    return analyse(prof, time.perf_counter() - t0, count)
