"""Which collectives a gloo group takes on CUDA tensors, on one card.

Two processes on cuda:0 join a gloo group (NCCL refuses two ranks on one
device) and call each collective the port's mesh issues, raw, on CUDA
tensors: all_reduce, broadcast, all_gather, batch_isend_irecv (the
halo's send and receive), and broadcast_object_list and
all_gather_object (which gloo runs on host tensors). Each runs in a
fresh pair of processes, since gloo may abort the process rather than
raise (a device pointer handed to the socket); a raise or an abort is
recorded as a refusal (this script's purpose is to record them, so it
catches them), and the value of each collective that runs is checked.
Prints one JSON line and exits 0.

    python3 tools/gloo_cuda_probe.py

``partner_tpu_torch/parallel/dist.py`` copies through the host on a gloo
group where this probe records a refusal.
"""

import json
import os
import socket
import sys

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp


def _collectives(rank, world, dev):
    """name -> (call, check of its result) on this rank."""
    x = torch.full((4,), float(rank + 1), device=dev)
    total = sum(range(1, world + 1))

    def all_reduce():
        t = x.clone()
        tdist.all_reduce(t)
        return t

    def broadcast():
        t = x.clone()
        tdist.broadcast(t, src=0)
        return t

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        tdist.all_gather(parts, x)
        return torch.cat(parts)

    def send_recv():
        got = torch.empty_like(x)
        ops = [tdist.P2POp(tdist.isend, x, (rank + 1) % world),
               tdist.P2POp(tdist.irecv, got, (rank - 1) % world)]
        for w in tdist.batch_isend_irecv(ops):
            w.wait()
        return got

    def broadcast_object():
        box = [{"rank": rank, "t": x.cpu()}]
        tdist.broadcast_object_list(box, src=0)
        return box[0]

    def gather_object():
        outs = [None] * world
        tdist.all_gather_object(outs, {"rank": rank})
        return outs

    return {
        "all_reduce": (all_reduce, lambda t: bool((t == total).all())),
        "broadcast": (broadcast, lambda t: bool((t == 1).all())),
        "all_gather": (all_gather, lambda t: t.tolist() == sum(
            ([float(r + 1)] * 4 for r in range(world)), [])),
        "batch_isend_irecv": (send_recv, lambda t: bool(
            (t == ((rank - 1) % world) + 1).all())),
        "broadcast_object_list": (broadcast_object,
                                  lambda o: o["rank"] == 0),
        "all_gather_object": (gather_object, lambda o: [
            r["rank"] for r in o] == list(range(world)))}


NAMES = ("all_reduce", "broadcast", "all_gather", "batch_isend_irecv",
         "broadcast_object_list", "all_gather_object")


def _probe(rank, world, port, name, out):
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=world)
    call, check = _collectives(rank, world, torch.device("cuda", 0))[name]
    try:
        got = call()
        torch.cuda.synchronize()
        out[rank] = "ok" if check(got) else f"wrong value {got}"
    except Exception as e:      # a refusal is the reading
        out[rank] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    tdist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_probe: no CUDA device")
    world, res = 2, {}
    with mp.Manager() as manager:
        for name in NAMES:
            out = manager.dict()
            try:
                mp.spawn(_probe, args=(world, _free_port(), name, out),
                         nprocs=world, join=True)
                res[name] = sorted(set(out.values()))
            except mp.ProcessExitedException as e:   # gloo aborted
                res[name] = [f"refused: the process aborted ({e})"]
            print(json.dumps({name: res[name]}), flush=True)
    print(json.dumps({"torch": torch.__version__,
                      "card": torch.cuda.get_device_name(0), **res}),
          flush=True)


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
