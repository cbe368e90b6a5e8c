"""Multi-rank CPU runs of partner_tpu_torch's data parallelism and mesh.

The test files (``tests/test_torch_dist.py``, ``test_torch_halo.py``,
``test_torch_mesh_*.py``)
write a job (a ``torch.save`` of a list of tasks, each with its inputs:
weights, the global batch, a config), launch ``WORLD`` processes of this
file as torchrun would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment, one gloo group), and
read back what each rank wrote (:func:`start`, :func:`collect`). The ranks import nothing of jax: the
references are computed by the test process.

    python tests/torch_dist_cases.py JOB OUT_DIR

Each task ``{"kind", "name", ...}`` runs on every rank, in the job's
order, and each rank writes ``OUT_DIR/<name>.rank<r>.pt``.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def free_port():
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT,
                                                               "tests")]))


def start(tasks, out_dir, world=WORLD):
    """Start ``tasks`` on ``world`` gloo ranks -> a handle for
    :func:`collect` (the caller may work meanwhile)."""
    os.makedirs(out_dir, exist_ok=True)
    job = os.path.join(out_dir, "job.pt")
    torch.save(tasks, job)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, out_dir],
        cwd=ROOT, env=rank_env(r, world, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return tasks, out_dir, procs


def collect(handle, timeout=600):
    """Wait for :func:`start`'s ranks -> {name: [rank 0's result, rank
    1's, ...]}. A rank that fails fails the call with its output."""
    tasks, out_dir, procs = handle
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1, deadline - time.time()))
                        [0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return {t["name"]: [torch.load(os.path.join(out_dir,
                                                f"{t['name']}.rank{r}.pt"),
                                   weights_only=False)
                        for r in range(len(procs))] for t in tasks}


def part(example, rank, world):
    """Rank ``rank``'s positional part of a global batch (numpy arrays and
    per-task lists of them, batch first) -> tensors."""
    def cut(a):
        n = a.shape[0] // world
        return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1)
                                                       * n]))

    return {k: [cut(a) for a in v] if isinstance(v, list) else cut(v)
            for k, v in example.items()}


def floats(metrics):
    return {k: [float(x) for x in v] if isinstance(v, list) else float(v)
            for k, v in metrics.items()}


def build(task):
    from partner_tpu_torch.models import build_detector

    det = build_detector(task["model"], None, task["test_cfg"], device="cpu")
    det.module.load_state_dict(task["state_dict"], strict=True)
    return det


def optimizer(det, task):
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer

    return build_one_cycle_optimizer(det.module, task.get("lr_max", 3e-3),
                                     task.get("total", 1000))


def step_result(det, met):
    """A step's metrics, each parameter's gradient and the module's state
    after it."""
    return {"metrics": floats(met),
            "grads": {n: p.grad.clone() for n, p in
                      det.module.named_parameters() if p.grad is not None},
            "state": {k: v.clone() for k, v in
                      det.module.state_dict().items()}}


def run_step(task, rank, world):
    """One train step of the task's detector on this rank's part of its
    global batch (data-parallel where a group exists)."""
    from partner_tpu_torch.parallel import dist
    from partner_tpu_torch.train.train_state import make_train_step

    det = build(task)
    step = make_train_step(det, optimizer(det, task))
    n0 = dist.counts["collectives"]
    met = step(part(task["example"], rank, world),
               torch.Generator().manual_seed(1000 * rank))
    out = step_result(det, met)
    out["collectives"] = dist.counts["collectives"] - n0
    return out


def run_norms(task, rank, world):
    """The port's BatchNorm and MaskedBatchNorm in train mode on this
    rank's part, inside a data-parallel step's reduction: outputs, input
    gradients of ``sum(out * cot)``, parameter gradients and the running
    statistics after."""
    from partner_tpu_torch.models.layers import BatchNorm, MaskedBatchNorm
    from partner_tpu_torch.parallel import dist

    out = {}
    for key, mod in (("bn", BatchNorm(task["c"], 1e-3, 0.99)),
                     ("masked", MaskedBatchNorm(task["c"]))):
        mod.load_state_dict(task[key + "_state"])
        mod.train()
        x = part({"x": task[key + "_x"]}, rank, world)["x"].requires_grad_()
        cot = part({"c": task[key + "_cot"]}, rank, world)["c"]
        with dist.reducing():
            if key == "masked":
                y = mod(x, part({"m": task["mask"]}, rank, world)["m"])
            else:
                y = mod(x)
            (y * cot).sum().backward()
        out[key] = {"y": y.detach(), "x_grad": x.grad,
                    "param_grads": {n: p.grad.clone() for n, p in
                                    mod.named_parameters()},
                    "state": dict(mod.state_dict())}
    return out


def run_gather(task, rank, world):
    """``all_gather_object`` of payloads of unequal size, and
    ``global_cat`` / ``global_sum`` with their gradients."""
    from partner_tpu_torch.parallel import dist

    objs = dist.all_gather_object({"rank": rank,
                                   "blob": np.arange(task["sizes"][rank])})
    x = torch.tensor(task["x"][rank], requires_grad=True)
    with dist.reducing():
        cat = dist.global_cat(x)
        tot = dist.global_sum(x)
        ((cat * torch.tensor(task["w_cat"])).sum()
         + (tot * torch.tensor(task["w_sum"][rank])).sum()).backward()
        flags = dist.global_cat(torch.tensor(task["flags"][rank]))
    return {"objs": objs, "cat": cat.detach(), "sum": tot.detach(),
            "x_grad": x.grad, "flags": flags}


def run_halo(task, rank, world):
    """``ring_halo`` and ``trailing_halo`` of this rank's azimuth shard,
    and ``RPNHalo(axis_name="azimuth")`` in eval mode, with the gradients
    of ``sum(out * cot)`` by the shard and by the neck's parameters."""
    import torch.distributed as tdist

    from partner_tpu_torch.models.registry import NECKS, build_from_cfg
    from partner_tpu_torch.parallel import halo

    halo.set_axis_group("azimuth", tdist.group.WORLD)
    out = {}

    def shard(a):
        n = a.shape[1] // world
        return torch.from_numpy(np.ascontiguousarray(
            a[:, rank * n:(rank + 1) * n]))

    for key, fn in (("ring", halo.ring_halo), ("trailing",
                                                halo.trailing_halo)):
        x = shard(task["x"]).requires_grad_()
        y = fn(x, task["pads"][key], "azimuth", axis=1)
        (y * shard(task[key + "_cot"])).sum().backward()
        out[key] = {"y": y.detach(), "x_grad": x.grad}
    neck = build_from_cfg(dict(task["neck"], axis_name="azimuth"), NECKS)
    neck.load_state_dict(task["neck_state"])
    neck.eval()
    x = shard(task["neck_x"]).requires_grad_()
    y = neck(x)
    (y * shard(task["neck_cot"])).sum().backward()
    out["neck"] = {"y": y.detach(), "x_grad": x.grad,
                   "param_grads": {n: p.grad.clone() for n, p in
                                   neck.named_parameters()}}
    return out


class _TwoLayers(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.used = torch.nn.Linear(4, 3)
        self.unused = torch.nn.Linear(4, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


class _UsesOneLayer:
    """A detector whose loss reads one of its module's two layers: the
    mean of ``used(x)^2`` over the global batch."""

    def __init__(self):
        self.module = _TwoLayers()

    def loss(self, example, generator=None):
        from partner_tpu_torch.parallel.dist import global_sum

        y = self.module.used(example["x"])
        n = global_sum(torch.tensor(float(y.numel())))
        return {"loss": (y * y).sum() / n}


def run_unused(task, rank, world):
    """``task["steps"]`` SGD steps of :class:`_UsesOneLayer` on this rank's
    part of a global batch of 4 -> each step's gradients and state."""
    from partner_tpu_torch.train.optim import ChainOptimizer
    from partner_tpu_torch.train.train_state import make_train_step

    det = _UsesOneLayer()
    opt = ChainOptimizer(det.module.parameters(), lambda c: 0.1, "sgd",
                         wd=0.01)
    step = make_train_step(det, opt)
    x = np.random.RandomState(5).randn(4, 4).astype(np.float32)
    out = []
    for _ in range(task["steps"]):
        out.append(step_result(det, step(part({"x": x}, rank, world),
                                         None)))
    return out


def run_mesh_step(task, rank, world):
    """One train step on the mesh ``task["mesh"]`` (data, model, azimuth)
    of this rank's data coordinate's part of the global batch -> the
    step's metrics, the whole gradients and state (model slices gathered),
    the optimizer's state in the data-only layout, the sliced names, the
    shapes of this rank's Adam slots and its coordinates; with
    ``task["frame"]``, first the eval-mode module's neck output map on the
    batch part (``return_bev``); with ``task["neck_x"]``, then the neck of the eval-mode module on that
    map (``sharded_neck`` on an azimuth axis) with the gradients of
    ``sum(out * neck_cot)`` by the map and the neck's parameters (an
    azimuth rank's part: the cotangent scaled by 1 / K, as the step
    scales its loss's); with
    ``task["resume"]`` (a whole checkpoint payload), after the step, what
    a fresh detector and optimizer on the mesh resume from it."""
    from partner_tpu_torch.parallel import dist, mesh, tp
    from partner_tpu_torch.train.checkpoint import (optimizer_state,
                                                    restore_train_state)
    from partner_tpu_torch.train.train_state import make_train_step

    grid = mesh.build(*task["mesh"])
    det = build(task)
    sliced = mesh.place(det, grid)
    out = {"coords": grid.coords, "sliced": sliced}
    if task.get("frame"):   # the eval-mode neck output of the batch part
        with torch.no_grad():
            det.module.eval()
            out["bev"] = det.module(part(task["example"], grid.coords[0],
                                         grid.n_data), return_bev=True)[1]
    if "neck_x" in task:
        out["neck"] = neck_result(det, task)
    opt = optimizer(det, task)
    step = make_train_step(det, opt)
    d = grid.coords[0]
    n0 = dist.counts["collectives"]
    met = step(part(task["example"], d, grid.n_data),
               torch.Generator().manual_seed(1000 * d))
    out["collectives"] = dist.counts["collectives"] - n0
    names = [n for n, p in det.module.named_parameters() if p.requires_grad]
    out.update(
        metrics=floats(met),
        grads={n: tp.whole(p, p.grad) for n, p in
               det.module.named_parameters() if p.grad is not None},
        state=tp.full_state_dict(det.module),
        opt_state=optimizer_state(det.module, opt),
        slot_shapes={n: tuple(t.shape) for n, t in zip(names, opt.mu)})
    if "resume" in task:
        det2 = build(task)
        mesh.place(det2, grid)
        opt2 = optimizer(det2, task)
        restore_train_state(det2, opt2, task["resume"])
        out["resumed"] = {
            "state": {k: v.clone() for k, v in
                      det2.module.state_dict().items()},
            "mu": dict(zip(names, [t.clone() for t in opt2.mu])),
            "count": opt2.count}
    return out


def neck_result(det, task):
    """The eval-mode neck of ``det`` on ``task["neck_x"]`` (the whole map:
    this rank splits it where the neck is azimuth-sharded) -> its output,
    and the gradients of ``sum(out * task["neck_cot"])`` by the map and by
    the neck's parameters (model slices gathered; this azimuth rank's part
    of each, which sum over the azimuth ranks to the whole)."""
    from partner_tpu_torch.parallel import dist, tp

    mod = det.module
    mod.eval()
    x = torch.from_numpy(task["neck_x"]).requires_grad_()
    if mod.azimuth is None:
        y = mod.neck(x)
    else:   # every azimuth rank's cotangent is whole, as the step's
        y = dist.scale_grad(mod.sharded_neck(x), 1.0 / mod.azimuth.size)
    (y * torch.from_numpy(task["neck_cot"])).sum().backward()
    res = {"y": y.detach(), "x_grad": x.grad,
           "param_grads": {n: tp.whole(p, p.grad) for n, p in
                           mod.neck.named_parameters()}}
    for p in mod.parameters():
        p.grad = None
    return res


RUNS = {"step": run_step, "norms": run_norms, "gather": run_gather,
        "halo": run_halo, "unused": run_unused, "mesh_step": run_mesh_step}


def main(job, out_dir):
    from partner_tpu_torch.parallel import dist

    torch.set_num_threads(1)
    assert dist.initialize(device="cpu")
    rank, world = dist.process_info()
    for task in torch.load(job, weights_only=False):
        res = RUNS[task["kind"]](task, rank, world)
        torch.save(res, os.path.join(out_dir,
                                     f"{task['name']}.rank{rank}.pt"))
    torch.distributed.barrier()
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
    assert not bad, bad


if __name__ == "__main__":
    main(*sys.argv[1:3])
