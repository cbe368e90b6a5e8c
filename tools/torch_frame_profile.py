#!/usr/bin/env python3
"""Where the port's flagship frame spends its time on one CUDA card.

    python3 tools/torch_frame_profile.py [--frames 10] [--out DIR]

Builds the flagship detector of ``partner_tpu_torch`` exactly as
``chip_smoke.py`` does (full width and grid, bf16, seeded random weights,
the 180,000-point synthetic sweep), then:

1. times each stage of ``E2EDetector.predict`` (backbone, SetBlock, RPN,
   head, decode + NMS) with CUDA events recorded on the stream at every
   stage boundary, median over ``--frames`` frames; a stage's span
   includes the time the card waited for the host to enqueue its work;
2. traces three frames with ``torch.profiler`` and reports the summed
   device time of every kernel against the wall time (the device's busy
   share) and the kernels that take the most device time.

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


def stage_times(det, ex, frames):
    """Median ms per predict stage between CUDA events at the stage
    boundaries, and the median host time of the whole frame."""
    from partner_tpu_torch.models.layers import constant

    mod = det.module
    names = ["backbone", "setblock", "rpn", "head", "decode_nms"]
    per = {n: [] for n in names}
    totals = []
    for _ in range(frames):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        t0 = time.perf_counter()
        with torch.no_grad():
            ev[0].record()
            bev = mod.backbone.encode_points(
                ex["points"], ex["points_mask"], mod.grid_size, mod.pc_range)
            ev[1].record()
            pos = constant(mod, "bev_pos", bev.device,
                           lambda: mod.bev_pos)[None]
            x = mod.attns(bev.transpose(1, 2), pos).transpose(1, 2)
            ev[2].record()
            x = mod.neck(x)
            ev[3].record()
            preds = mod.bbox_head(x)
            ev[4].record()
            det.decode(preds)
            ev[5].record()
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        for i, n in enumerate(names):
            per[n].append(ev[i].elapsed_time(ev[i + 1]))
    out = {n: statistics.median(v) for n, v in per.items()}
    out["frame_host"] = statistics.median(totals)
    return out


def trace(det, ex, out_dir):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            det.predict(ex)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    prof.export_chrome_trace(os.path.join(out_dir, "frame_trace.json"))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / 3
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, "frame_kernels.txt"), "w") as f:
        f.write(table)
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.device_time / 1e3 / 3
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms_per_frame": wall_ms, "device_busy_ms_per_frame": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_launches_per_frame": len(kernels) / 3,
            "top_kernels_ms_per_frame": [
                {"name": n[:90], "ms": v[0], "calls": v[1] // 3}
                for n, v in top]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "frame_profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_frame_profile: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from partner_tpu_torch.models import build_detector

    dev = torch.device("cuda", 0)
    m, tc = chip_smoke.frame_cfgs()
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    det = build_detector(m, None, tc, device=dev, generator=gen)
    chip_smoke.randomize_norms(det.module, gen)
    pts, mask = chip_smoke.synthetic_sweep(
        np.random.RandomState(chip_smoke.SEED),
        m["bbox_head"]["voxel_generator"]["range"], chip_smoke.N_POINTS)
    ex = chip_smoke.to_device({"points": pts, "points_mask": mask}, dev)
    for _ in range(2):
        det.predict(ex)
    torch.cuda.synchronize()
    result = {"card": chip_smoke.gpu_name_and_power_limit(),
              "torch": torch.__version__,
              "stage_ms": stage_times(det, ex, args.frames)}
    result["trace"] = trace(det, ex, args.out)
    with open(os.path.join(args.out, "frame_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
