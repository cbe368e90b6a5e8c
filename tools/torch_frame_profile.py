#!/usr/bin/env python3
"""Where the port's flagship frame or train step spends its time on one
CUDA card.

    python3 tools/torch_frame_profile.py [--frames 10] [--out DIR]
                                         [--use-block-kernel] [--train]
                                         [--model flagship|centerpoint|
                                                  centerpoint-velo|sparse]

Builds the flagship detector of ``partner_tpu_torch`` exactly as
``chip_smoke.py`` does (full width and grid, bf16, seeded random weights,
the 180,000-point synthetic sweep; ``--use-block-kernel`` puts the head on
its whole-block route), then:

1. times each stage of ``E2EDetector.predict`` (backbone, SetBlock, RPN,
   head, decode + NMS) with CUDA events recorded on the stream at every
   stage boundary, median over ``--frames`` frames; a stage's span
   includes the time the card waited for the host to enqueue its work;
2. traces three frames with ``torch.profiler`` and reports the summed
   device time of every kernel against the wall time (the device's busy
   share) and the kernels that take the most device time.

``--model centerpoint`` profiles the CenterPoint frame of
``chip_smoke.py``'s CenterPoint phase instead (the one-sweep config on the
same sweep; ``centerpoint-velo``: the two-sweep config on 2 x 180,000
points in 432,000 rows), with the stages backbone, RPN, head and decode +
NMS. ``--model sparse`` profiles the flagship with the sparse
``SpMiddleResNetFHD`` backbone (``chip_smoke.sparse_cfgs``) on the sweep's
``dynamic_voxelize`` example (the voxelizer outside the frame), and also
traces the backbone alone.

``--train`` profiles the flagship train step instead, on ``chip_smoke.py``'s
train batch (4 synthetic 150,000-point sweeps with their boxes and vote
maps): per step the spans of the forward, the set losses (the auction
matcher with its host checks included), the backward and the optimizer,
then a trace of three steps, which also sums the host's blocking reads of
device values (``aten::_local_scalar_dense``).

Prints one JSON object as its last line and writes the chrome trace and
the kernel table under ``--out``. Needs a CUDA card; it does not fall back
to the CPU.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (its config, weights and sweep builders)


def backbone_stage(mod, ex):
    """The backbone of a frame: the point path, or the reader and the
    backbone on a voxel example."""
    if "features" in ex:
        return mod.backbone(mod.reader(ex["features"]), ex["coords"],
                            ex["voxel_mask"], mod.grid_size)
    return mod.backbone.encode_points(ex["points"], ex["points_mask"],
                                      mod.grid_size, mod.pc_range)


def stage_times(det, ex, frames):
    """Median ms per predict stage between CUDA events at the stage
    boundaries, and the median host time of the whole frame."""
    from partner_tpu_torch.models.layers import constant

    mod = det.module
    names = ["backbone", "setblock", "rpn", "head", "decode_nms"]
    if not mod.with_set_attention:
        names.remove("setblock")
    per = {n: [] for n in names}
    totals = []
    for _ in range(frames):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        t0 = time.perf_counter()
        with torch.no_grad():
            ev[0].record()
            x = backbone_stage(mod, ex)
            ev[1].record()
            if mod.with_set_attention:
                pos = constant(mod, "bev_pos", x.device,
                               lambda: mod.bev_pos)[None]
                x = mod.attns(x.transpose(1, 2), pos).transpose(1, 2)
                ev[2].record()
            x = mod.neck(x)
            ev[-3].record()
            preds = mod.bbox_head(x)
            ev[-2].record()
            det.decode(preds)
            ev[-1].record()
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        for i, n in enumerate(names):
            per[n].append(ev[i].elapsed_time(ev[i + 1]))
    out = {n: statistics.median(v) for n, v in per.items()}
    out["frame_host"] = statistics.median(totals)
    return out


def train_stage_times(det, opt, ex, steps, gen):
    """Median ms per train-step span (forward, set losses, backward,
    optimizer) between CUDA events, and the median host time of a step."""
    names = ["forward", "set_losses", "backward", "optimizer"]
    per = {n: [] for n in names}
    totals = []
    det.module.train()
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in opt.params:
            p.grad = None
        t0 = time.perf_counter()
        ev[0].record()
        preds = det.module(ex, gen)
        ev[1].record()
        losses = det.set_losses(preds, ex)
        ev[2].record()
        losses["loss"].backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        for i, n in enumerate(names):
            per[n].append(ev[i].elapsed_time(ev[i + 1]))
    out = {n: statistics.median(v) for n, v in per.items()}
    out["step_host"] = statistics.median(totals)
    return out


def trace(run, out_dir, tag):
    """Profile three calls of ``run``: device busy share, launches, the
    largest kernels and the host's blocking reads, per call."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))
    reads = [e for e in prof.events() if e.name == "aten::_local_scalar_dense"]
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / 3
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, f"{tag}_kernels.txt"), "w") as f:
        f.write(table)
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.device_time / 1e3 / 3
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_launches_per_call": len(kernels) / 3,
            "host_reads_per_call": len(reads) / 3,
            "host_read_ms_per_call": sum(e.cpu_time_total for e in reads)
            / 1e3 / 3,
            "top_kernels_ms_per_call": [
                {"name": n[:90], "ms": v[0], "calls": v[1] // 3}
                for n, v in top]}


def profile_frame(dev, args):
    from partner_tpu_torch.models import build_detector

    n_points, c = chip_smoke.N_POINTS, 7
    if args.model == "flagship":
        m, tc = chip_smoke.frame_cfgs()
    elif args.model == "sparse":
        m, tc = chip_smoke.sparse_cfgs()
    elif args.model == "centerpoint":
        m, _, tc = chip_smoke.centerpoint_cfgs()
    else:   # the two-sweep velocity config: 8 features, twice the points
        m, _, tc = chip_smoke.centerpoint_cfgs(chip_smoke.CP_VELO_CONFIG)
        n_points, c = 2 * chip_smoke.N_POINTS, 8
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    det = build_detector(m, None, tc, device=dev, generator=gen,
                         use_block_kernel=args.use_block_kernel)
    chip_smoke.randomize_norms(det.module, gen)
    pts, mask = chip_smoke.synthetic_sweep(
        np.random.RandomState(chip_smoke.SEED),
        m["bbox_head"]["voxel_generator"]["range"], n_points, c=c)
    ex = chip_smoke.to_device({"points": pts, "points_mask": mask}, dev)
    if args.model == "sparse":
        from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

        vg = m["bbox_head"]["voxel_generator"]
        ex = DeviceVoxelizer(vg, dev, vg["max_voxel_num"])(
            ex["points"], ex["points_mask"])
    for _ in range(2):
        det.predict(ex)
    torch.cuda.synchronize()
    out = {"card": chip_smoke.gpu_name_and_power_limit(),
           "torch": torch.__version__, "model": args.model,
           "use_block_kernel": args.use_block_kernel,
           "stage_ms": stage_times(det, ex, args.frames),
           "trace": trace(lambda: det.predict(ex), args.out,
                          args.model.replace("flagship", "frame"))}
    if args.model == "sparse":
        with torch.no_grad():
            out["backbone_trace"] = trace(
                lambda: backbone_stage(det.module, ex), args.out,
                "sparse_backbone")
    return out


def profile_train(dev, args):
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    m, tc, batch, lr_max = chip_smoke.train_cfgs()
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 3)
    det = build_detector(m, None, tc, device=dev, generator=gen,
                         use_block_kernel=args.use_block_kernel)
    chip_smoke.randomize_norms(det.module, gen)
    ex = chip_smoke.to_device(chip_smoke.train_example(
        np.random.RandomState(chip_smoke.SEED + 3),
        m["bbox_head"]["voxel_generator"]["range"], det.module.grid_size,
        batch, chip_smoke.TRAIN_POINTS, chip_smoke.TRAIN_ROWS,
        chip_smoke.MAX_BOXES), dev)
    opt = build_one_cycle_optimizer(det.module, lr_max=lr_max,
                                    total_steps=1000)
    step = make_train_step(det, opt)
    drops = torch.Generator().manual_seed(chip_smoke.SEED + 3)
    for _ in range(2):
        step(ex, drops)
    torch.cuda.synchronize()
    return {"card": chip_smoke.gpu_name_and_power_limit(),
            "torch": torch.__version__, "batch": batch,
            "stage_ms": train_stage_times(det, opt, ex, args.frames, drops),
            "trace": trace(lambda: step(ex, drops), args.out, "train")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "frame_profile"))
    ap.add_argument("--use-block-kernel", action="store_true",
                    help="the head's whole-block route")
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the frame")
    ap.add_argument("--model", default="flagship",
                    choices=["flagship", "centerpoint", "centerpoint-velo",
                             "sparse"],
                    help="the frame's model (the train step: flagship)")
    args = ap.parse_args()
    if args.train and args.model != "flagship":
        sys.exit("torch_frame_profile: --train profiles the flagship only")
    if not torch.cuda.is_available():
        sys.exit("torch_frame_profile: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from partner_tpu_torch.models import build_detector

    dev = torch.device("cuda", 0)
    if args.train:
        result = profile_train(dev, args)
    else:
        result = profile_frame(dev, args)
    name = ("train_profile.json" if args.train
            else f"{args.model.replace('flagship', 'frame')}_profile.json")
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
