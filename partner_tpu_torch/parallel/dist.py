"""Process group and collectives (counterpart of
``partner_tpu/parallel/dist.py``).

The JAX package trains on a device mesh: XLA reduces every batch-level
statistic and the gradients over the whole sharded batch. The port runs
one process per card, launched by ``torchrun`` (``python -m
torch.distributed.run``); :func:`initialize` joins the group torchrun
describes. Inside a data-parallel train step (:func:`reducing`, entered by
``train.train_state.make_train_step`` when a group exists) the model's
batch-level sums go through :func:`global_sum` and :func:`global_cat`, so
each rank computes the statistics of the global batch, as JAX does. Both
carry autograd: the backward of a sum is the sum of every rank's
cotangent, and that of a gather hands each rank the sum of the cotangents
of its own rows (an all-reduce of the whole cotangent, so no
``reduce_scatter`` is needed: gloo has none). Outside :func:`reducing` both
are the identity, and the step computes what one process computes.

The model's collectives run on groups of their own, apart from the
gradient group that ``DistributedDataParallel`` reduces on
(``parallel.mesh``: the statistics on the ``data`` group, or inside an
azimuth-sharded neck on ``neck``; the gradients on ``grad``), so the
streams of collectives never have to interleave alike on every rank.
``counts["collectives"]`` counts every collective this module and the
train step's gradient hook issue.

Two processes sharing one card run gloo (NCCL refuses two ranks on one
device). On an NVIDIA H100 with torch 2.11, gloo takes CUDA tensors in
``all_reduce``, ``broadcast`` and ``all_gather`` and aborts the process
on a point-to-point send of one (``tools/gloo_cuda_probe.py``), so on a
gloo group the halo's sends (:func:`exchange`) go through host copies.
NCCL takes them as they are.
"""

import contextlib
import os

import torch
import torch.distributed as tdist

from . import mesh

counts = {"collectives": 0}
_state = {"group": None, "owned": False}


def initialize(device="cuda"):
    """Join the process group that torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` describe -> True;
    without them (one process, no launcher), or with a group already
    there, a no-op -> False. NCCL for a CUDA ``device``, after
    ``torch.cuda.set_device(LOCAL_RANK)``, so that each rank's
    communicator lives on its own card; gloo for the CPU."""
    if tdist.is_initialized():
        return False
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        backend = "nccl"
    else:
        backend = "gloo"
    addr = env.get("MASTER_ADDR", "localhost")
    port = env.get("MASTER_PORT", "29500")
    tdist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                             rank=rank, world_size=world)
    _state["owned"] = True
    return True


def finalize():
    """Leave the group :func:`initialize` made (after a barrier)."""
    if _state["owned"] and tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()
    _state.update(group=None, owned=False)
    mesh.set_current(None)


def process_info():
    """-> (rank, world size); (0, 1) without a group."""
    if not tdist.is_initialized():
        return 0, 1
    return tdist.get_rank(), tdist.get_world_size()


def is_main_process():
    return process_info()[0] == 0


def broadcast_object(obj, src, group):
    """The global rank ``src``'s picklable ``obj`` on every rank of
    ``group`` (``obj`` is read on ``src`` only), counted."""
    box = [obj]
    counts["collectives"] += 1
    tdist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_gather_object(obj):
    """Every rank's picklable ``obj`` -> a list in rank order (payloads of
    any size); ``[obj]`` without a group."""
    if not tdist.is_initialized():
        return [obj]
    out = [None] * tdist.get_world_size()
    counts["collectives"] += 1
    tdist.all_gather_object(out, obj)
    return out


@contextlib.contextmanager
def reducing(group=None):
    """Inside, :func:`global_sum` and :func:`global_cat` reduce over
    ``group``, by default the current mesh's ``data`` group (with no mesh
    built, a data-only mesh of the running group)."""
    old = _state["group"]
    _state["group"] = mesh.current().data if group is None else group
    try:
        yield _state["group"]
    finally:
        _state["group"] = old


def world_size():
    """The size of the active group; 1 outside :func:`reducing`."""
    g = _state["group"]
    return 1 if g is None else tdist.get_world_size(g)


def all_reduce_(t, group):
    """In-place sum over ``group``, counted."""
    counts["collectives"] += 1
    tdist.all_reduce(t, group=group)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_gather(t, group):
    """Every rank's ``t`` (one shape on every rank) over ``group`` -> a
    list in group rank order, counted."""
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(tdist.get_world_size(group))]
    counts["collectives"] += 1
    tdist.all_gather(parts, src, group=group)
    return parts


def exchange(t, dst, src, group):
    """Send ``t`` to the global rank ``dst`` and return what the global
    rank ``src`` sent (one ``batch_isend_irecv``; a CUDA tensor on a gloo
    group through the host), counted."""
    t = t.contiguous()
    host = t.is_cuda and tdist.get_backend(group) == "gloo"
    send = t.cpu() if host else t
    out = torch.empty_like(send)
    counts["collectives"] += 1
    ops = [tdist.P2POp(tdist.isend, send, dst, group),
           tdist.P2POp(tdist.irecv, out, src, group)]
    for w in tdist.batch_isend_irecv(ops):
        w.wait()
    return out.to(t.device) if host else out


class _CatOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.rows = group, dim, t.shape[dim]
        ctx.rank = tdist.get_rank(group)
        return torch.cat(all_gather(t, group), dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.clone(memory_format=torch.contiguous_format),
                        ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.rows, ctx.rows), None, None


def cat_over(t, group, dim=0):
    """Every rank's ``t`` over ``group`` concatenated along ``dim`` in
    group rank order (autograd: each rank's part gets the sum of every
    rank's cotangent of it, an all-reduce of the whole cotangent, so no
    ``reduce_scatter`` is needed: gloo has none)."""
    if t.requires_grad:
        return _CatOver.apply(t, group, dim)
    flag = t.dtype == torch.bool
    out = torch.cat(all_gather(t.to(torch.uint8) if flag else t, group), dim)
    return out.bool() if flag else out


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(t, scale):
    """``t`` itself, whose cotangent is scaled by ``scale`` on its way
    back."""
    return _ScaleGrad.apply(t, scale)


def global_sum(t):
    """The sum of ``t`` over the ranks of the active group (autograd: the
    cotangent is summed over the ranks too); ``t`` itself outside
    :func:`reducing`."""
    g = _state["group"]
    if g is None:
        return t
    if not t.requires_grad:
        return all_reduce_(t.clone(memory_format=torch.contiguous_format), g)
    return _GlobalSum.apply(t, g)


def global_cat(t):
    """Every rank's ``t`` (one shape on every rank) concatenated along
    dim 0 in rank order, i.e. the global batch's rows in their order
    (autograd: each rank's rows get the sum of every rank's cotangent of
    them); ``t`` itself outside :func:`reducing`."""
    g = _state["group"]
    return t if g is None else cat_over(t, g, 0)


def sum_terms(terms, group):
    """A dict of 0-d tensors and lists of them (a step's loss parts) ->
    the same dict summed over ``group`` in one all-reduce, detached."""
    keys = list(terms)
    flat, sizes = [], []
    for k in keys:
        v = terms[k]
        vs = v if isinstance(v, list) else [v]
        sizes.append(len(v) if isinstance(v, list) else 0)
        flat += [torch.as_tensor(x).detach().float().reshape(1) for x in vs]
    dev = next((x.device for x in flat if x.device.type != "cpu"),
               flat[0].device)
    tot = all_reduce_(torch.cat([x.to(dev) for x in flat]), group)
    out, i = {}, 0
    for k, n in zip(keys, sizes):
        out[k] = list(tot[i: i + n]) if n else tot[i]
        i += max(n, 1)
    return out


def sum_gradients_hook(group, bucket):
    """``DistributedDataParallel`` comm hook (its state the gradient
    ``group``): sum each gradient bucket over the group (DDP's own hook
    averages). Each rank's loss is its part of the global loss, so the sum
    is the global batch's gradient."""
    counts["collectives"] += 1
    fut = tdist.all_reduce(bucket.buffer(), group=group,
                           async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])
