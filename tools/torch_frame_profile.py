#!/usr/bin/env python3
"""Where the port's flagship frame or train step spends its time on one
CUDA card.

    python3 tools/torch_frame_profile.py [--frames 10] [--out DIR]
                                         [--use-block-kernel] [--train]
                                         [--model flagship|centerpoint|
                                                  centerpoint-velo|sparse|
                                                  nusc-dcn|nusc-01voxel|
                                                  nusc-dcn_flip|
                                                  nusc-singlehead|pp|
                                                  pp-two_cls|
                                                  nusc-polarstream-1|
                                                  nusc-polarstream-4|
                                                  nusc-seg-10sweep|
                                                  nusc-seg-cylinder|
                                                  nusc-polarstream-seg-1|
                                                  nusc-polarstream-seg-4|
                                                  nusc-polarstream-seg-4te|
                                                  nusc-han-1|nusc-han-4|
                                                  nusc-strobe-1|
                                                  nusc-strobe-4]
                                         [--part frame|rpn] [--batch B]

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
traces the backbone alone. ``--model nusc-<name>`` profiles a nuScenes
CenterPoint config of ``chip_smoke.py``'s nuScenes phase (``dcn``,
``01voxel``, ``dcn_flip``, its offset convs drawn too, or ``singlehead``,
the single-head cylinder config with its per-class NMS) on one synthetic
10-sweep sample (``chip_smoke.nusc_example``; the flip config's four
copies), and also traces one deformable branch alone (the DCN configs).
``--model pp`` profiles a Waymo PointPillars config of ``chip_smoke.py``'s
PointPillars phase (``pp``: 3 classes, ``pp-two_cls``: 2) on the cuboid
180,000-point sweep (``chip_smoke.cuboid_sweep``), with the stages
pillars (``encode_canvas``: ``dynamic_voxelize`` on the pillar grid, the
PFN and the scatter), RPN, head and decode + NMS, and also traces the
pillar stage alone and times its parts on the card (``pillar_parts``:
the pillarizer, the PFN, each PFN layer's pooled max at the frame's
pillars beside its bound). ``--batch B`` runs B sweeps a frame (the
PointPillars models, ``nusc-singlehead`` and the PolarStream models;
seeds SEED .. SEED + B - 1). ``--model nusc-polarstream-1`` /
``nusc-polarstream-4`` profiles a PolarStream det config of
``chip_smoke.py``'s PolarStream phase (1 sector, ``RPNTECP``; 4 sectors,
``RPNBDCP``) on a synthetic 11-sweep sample in POLAR_ROWS rows, with the
stages, each summed over the sectors: sector inputs (the sector buffers
and their rotation), pillars (``encode_sector``), neck, head, and decode +
stateful NMS; ``--part rpn`` times each conv of its stream neck on the
input sector 0 hands it. ``--model nusc-polarstream-seg-1|4|4te``
profiles a det + seg PolarStream config of ``chip_smoke.py``'s seg phase
(1 sector; 4 sectors, ``RPNBDCP``; 4 sectors, ``RPNTECP``) the same way,
with two more stages: the seg head (summed over the sectors) and the
point labels (``point_seg_labels`` from the sector maps).
``--model nusc-seg-10sweep|nusc-seg-cylinder`` profiles a seg-only
VoxelNet config (``SpMiddleResNetFHD`` through voxel inputs,
``DeconvConvHead``) on one synthetic 10-sweep sample in NUSC_ROWS rows,
voxelized on the card outside the frame (the second ``max_voxel_num``),
with the stages backbone (reader and sparse backbone), RPN, seg head and
point labels.
``--model nusc-han-1|nusc-han-4|nusc-strobe-1|nusc-strobe-4`` profiles a
HAN or STROBE config of ``chip_smoke.py``'s STROBE and HAN phase on one
synthetic 10-sweep sample in POLAR_ROWS rows (STROBE: split into its 10
sweep slots by ``chip_smoke.sweep_split``), with the stages, each summed
over the sweeps and sectors: sector inputs, pillars (``encode_canvas`` /
``encode_sector``), the sector LSTM (HAN 4-sector), neck, head, seg head,
decode + NMS and, for the sector models, the point labels; ``rest`` is
the frame's device timeline outside them. ``--part rpn`` times each conv
of its neck on the input the frame's first sweep or sector hands it
(``RPNWaymo``'s ConvLSTM ``memory.gates`` and ``RPNUber``'s doubled
first-block input among them).
``--part rpn`` times each conv of the model's RPN alone instead, on the
input the frame hands it: device ms and the kernels cuDNN picks, as the
port calls the conv (channels-last strides), NCHW-contiguous,
channels-last with a channels-last weight, one sample a call, and with
TF32 allowed; for the PointPillars models the head's convs too, each
beside its float32 bound (``chip_smoke.bound``: its FLOPs at the float32
peak or its bytes, input, weight and output once, at the memory rate).

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

POLAR_MODELS = {"nusc-polarstream-1": "1_sector",
                "nusc-polarstream-4": "4_sector"}
SH_MODELS = {"nusc-han-1": "han_1", "nusc-han-4": "han_4",
             "nusc-strobe-1": "strobe_1", "nusc-strobe-4": "strobe_4"}
SEG_MODELS = {"nusc-seg-10sweep": "voxelnet_10sweep",
              "nusc-seg-cylinder": "voxelnet_cylinder",
              "nusc-polarstream-seg-1": "polarstream_1",
              "nusc-polarstream-seg-4": "polarstream_4",
              "nusc-polarstream-seg-4te": "polarstream_4te"}


def backbone_stage(mod, ex):
    """The backbone of a frame: the point path, or the reader and the
    backbone on a voxel example, or the pillar canvas."""
    if hasattr(mod, "encode_canvas"):
        return mod.encode_canvas(ex["points"], ex["points_mask"])
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
    set_attention = getattr(mod, "with_set_attention", False)
    names = ["backbone", "setblock", "rpn", "head", "decode_nms"]
    if not set_attention:
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
            if set_attention:
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


def polar_stage_times(det, ex, frames):
    """A PolarStream frame's median ms per stage between CUDA events, each
    stage summed over the sectors, and the median host time of the
    frame."""
    mod = det.module
    names = ["sector_inputs", "pillars", "neck", "head", "decode_nms"]
    if mod.seg_head is not None:
        names[4:4] = ["seg_head"]
        names.append("point_labels")
    per = {n: [] for n in names}
    totals = []
    for _ in range(frames):
        spans = dict.fromkeys(names, 0.0)
        marks = []
        t0 = time.perf_counter()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        with torch.no_grad():
            mark(None)
            inputs = mod.sector_inputs(ex["points"], ex["points_mask"])
            mark("sector_inputs")
            preds, segs, ctx = [], [], None
            for p, v in inputs:
                canvas = mod.encode_sector(p, v)
                mark("pillars")
                x, ctx = mod.neck(canvas, ctx)
                mark("neck")
                preds.append(mod.bbox_head(x))
                mark("head")
                if mod.seg_head is not None:
                    segs.append(mod.seg_head(canvas, x)["seg_preds"])
                    mark("seg_head")
            det.decode({"sector_preds": preds})
            mark("decode_nms")
            if segs:
                det.point_seg_labels(segs, ex)
                mark("point_labels")
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        for (_, a), (name, b) in zip(marks, marks[1:]):
            spans[name] += a.elapsed_time(b)
        for n in names:
            per[n].append(spans[n])
    out = {n: statistics.median(v) for n, v in per.items()}
    out["frame_host"] = statistics.median(totals)
    return out


def sh_stage_times(det, ex, frames):
    """A HAN or STROBE frame's median ms per stage, each the sum of the
    spans between CUDA events recorded around every call of that stage's
    module or method inside ``det.predict`` (so summed over the sweeps and
    sectors), ``rest`` the frame's event-to-event span outside them, and
    the median host time of the frame."""
    mod = det.module
    sites = {"sector_inputs": (mod, "sector_inputs"),
             "pillars": (mod, "encode_sector" if hasattr(mod, "encode_sector")
                         else "encode_canvas"),
             "lstm": (getattr(mod, "lstm", None), "forward"),
             "neck": (mod.neck, "forward"),
             "head": (mod.bbox_head, "forward"),
             "seg_head": (mod.seg_head, "forward"),
             "decode_nms": (det, "decode"),
             "point_labels": (det, "point_seg_labels")}
    sites = {n: (o, a) for n, (o, a) in sites.items()
             if o is not None and hasattr(o, a)}
    calls = []

    def wrap(name, fn):
        def run(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            calls.append((name, a, b))
            return out
        return run

    for name, (owner, attr) in sites.items():
        setattr(owner, attr, wrap(name, getattr(owner, attr)))
    per = {n: [] for n in list(sites) + ["rest", "frame_host"]}
    try:
        for _ in range(frames):
            calls.clear()
            t0 = time.perf_counter()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            det.predict(ex)
            b.record()
            torch.cuda.synchronize()
            per["frame_host"].append((time.perf_counter() - t0) * 1e3)
            spans = dict.fromkeys(sites, 0.0)
            for name, x, y in calls:
                spans[name] += x.elapsed_time(y)
            for n, v in spans.items():
                per[n].append(v)
            per["rest"].append(a.elapsed_time(b) - sum(spans.values()))
    finally:
        for owner, attr in sites.values():
            owner.__dict__.pop(attr, None)
    return {n: statistics.median(v) for n, v in per.items()}


def seg_stage_times(det, ex, frames):
    """A seg-only VoxelNet frame's median ms per stage (backbone, RPN, seg
    head, point labels) between CUDA events, and the median host time of
    the frame."""
    from partner_tpu_torch.models.seg_head import (point_labels_from_grid,
                                                   points_to_grid_cells)

    mod = det.module
    names = ["backbone", "rpn", "seg_head", "point_labels"]
    per = {n: [] for n in names}
    totals = []
    for _ in range(frames):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t0 = time.perf_counter()
        with torch.no_grad():
            ev[0].record()
            bev = backbone_stage(mod, ex)
            ev[1].record()
            x = mod.neck(bev)
            ev[2].record()
            sp = mod.seg_head(bev, x)["seg_preds"]
            ev[3].record()
            gi, ok = points_to_grid_cells(ex["points"], ex["points_mask"],
                                          sp.shape[1:3], mod.pc_range,
                                          det.voxel_shape)
            torch.where(ok, point_labels_from_grid(sp, gi), 0)
            ev[4].record()
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


def build_frame(dev, args):
    """The detector of ``--model`` and its frame's example on the card."""
    from partner_tpu_torch.models import build_detector

    n_points, c = chip_smoke.N_POINTS, 7
    if args.model in SEG_MODELS:
        return build_seg_frame(dev, args)
    if args.model in SH_MODELS:
        return build_sh_frame(dev, args)
    if args.model == "flagship":
        m, tc = chip_smoke.frame_cfgs()
    elif args.model == "sparse":
        m, tc = chip_smoke.sparse_cfgs()
    elif args.model == "centerpoint":
        m, _, tc = chip_smoke.centerpoint_cfgs()
    elif args.model in POLAR_MODELS:
        m, _, tc = chip_smoke.centerpoint_cfgs(chip_smoke.POLAR_CONFIGS[
            POLAR_MODELS[args.model]])
    elif args.model.startswith("nusc-"):
        m, _, tc = chip_smoke.centerpoint_cfgs(
            chip_smoke.NUSC_ALL[args.model[5:]])
    elif args.model.startswith("pp"):
        m, _, tc = chip_smoke.pp_cfgs(chip_smoke.PP_CONFIGS[
            "two_class" if args.model == "pp-two_cls" else "three_class"])
    else:   # the two-sweep velocity config: 8 features, twice the points
        m, _, tc = chip_smoke.centerpoint_cfgs(chip_smoke.CP_VELO_CONFIG)
        n_points, c = 2 * chip_smoke.N_POINTS, 8
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    det = build_detector(m, None, tc, device=dev, generator=gen,
                         use_block_kernel=args.use_block_kernel)
    chip_smoke.randomize_norms(det.module, gen)
    if args.model in POLAR_MODELS:
        chip_smoke.randomize_pfn(det.module, gen)
        samples = [chip_smoke.nusc_example(
            None, seed=chip_smoke.SEED + i,
            config=chip_smoke.POLAR_CONFIGS[POLAR_MODELS[args.model]],
            sweeps=chip_smoke.POLAR_SWEEPS, rows=chip_smoke.POLAR_ROWS)
            for i in range(args.batch)]
        ex = chip_smoke.to_device({k: np.concatenate([e[k] for e in samples])
                                   for k in samples[0]}, dev)
    elif args.model.startswith("nusc-"):
        chip_smoke.randomize_offsets(det.module, gen)
        samples = [chip_smoke.nusc_example(args.model[5:],
                                           seed=chip_smoke.SEED + i)
                   for i in range(args.batch)]
        ex = chip_smoke.to_device({k: np.concatenate([e[k] for e in samples])
                                   for k in samples[0]}, dev)
    elif args.model.startswith("pp"):
        chip_smoke.randomize_pfn(det.module, gen)
        sweeps = [chip_smoke.cuboid_sweep(
            np.random.RandomState(chip_smoke.SEED + i),
            m["bbox_head"]["voxel_generator"]["range"], n_points)
            for i in range(args.batch)]
        ex = chip_smoke.to_device(
            {"points": np.concatenate([p for p, _ in sweeps]),
             "points_mask": np.concatenate([k for _, k in sweeps])}, dev)
    else:
        pts, mask = chip_smoke.synthetic_sweep(
            np.random.RandomState(chip_smoke.SEED),
            m["bbox_head"]["voxel_generator"]["range"], n_points, c=c)
        ex = chip_smoke.to_device({"points": pts, "points_mask": mask}, dev)
    if args.model == "sparse":
        from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

        vg = m["bbox_head"]["voxel_generator"]
        ex = DeviceVoxelizer(vg, dev, vg["max_voxel_num"])(
            ex["points"], ex["points_mask"])
    return det, ex


def build_seg_frame(dev, args):
    """A seg config of ``chip_smoke.py``'s seg phase at full width (its
    norms drawn as there) and ``--batch`` synthetic samples (11 sweeps in
    POLAR_ROWS rows for PolarStream, 10 in NUSC_ROWS for VoxelNet), the
    VoxelNet ones voxelized on the card beside their points."""
    from partner_tpu_torch.utils.config import load_config

    config = chip_smoke.SEG_CONFIGS[SEG_MODELS[args.model]]
    cfg = load_config(config)
    cfg["test_cfg"]["score_threshold"] = 0.0
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    det, vox, _ = chip_smoke.seg_detector(cfg, dev, gen)
    polar = args.model.startswith("nusc-polarstream")
    samples = [chip_smoke.nusc_example(
        None, seed=chip_smoke.SEED + i, config=config,
        sweeps=chip_smoke.POLAR_SWEEPS if polar else chip_smoke.NUSC_SWEEPS,
        rows=chip_smoke.POLAR_ROWS if polar else chip_smoke.NUSC_ROWS)
        for i in range(args.batch)]
    ex = chip_smoke.to_device({k: np.concatenate([e[k] for e in samples])
                               for k in samples[0]}, dev)
    return det, chip_smoke.with_voxels(ex, vox)


def build_sh_frame(dev, args):
    """A HAN or STROBE config of ``chip_smoke.py``'s STROBE and HAN phase
    at full width (its norms drawn as there) and ``--batch`` synthetic
    10-sweep samples in POLAR_ROWS rows (``chip_smoke.nusc_example``),
    split into STROBE's sweep slots where the model takes them."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    config = chip_smoke.STROBE_HAN_CONFIGS[SH_MODELS[args.model]]
    cfg = load_config(config)
    tc = dict(cfg["test_cfg"], score_threshold=0.0)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    det = build_detector(cfg["model"], None, tc, device=dev, generator=gen)
    chip_smoke.randomize_norms(det.module, gen)
    chip_smoke.randomize_pfn(det.module, gen)
    samples = [chip_smoke.nusc_example(
        None, seed=chip_smoke.SEED + i, config=config,
        sweeps=chip_smoke.NUSC_SWEEPS, rows=chip_smoke.POLAR_ROWS)
        for i in range(args.batch)]
    ex = {k: np.concatenate([e[k] for e in samples]) for k in samples[0]}
    if det.input_kind == "sweeps":
        ex = chip_smoke.sweep_split(ex, chip_smoke.SH_SLOTS)
    return det, chip_smoke.to_device(
        {k: ex[k] for k in ("points", "points_mask")}, dev)


def profile_frame(dev, args):
    det, ex = build_frame(dev, args)
    for _ in range(2):
        det.predict(ex)
    torch.cuda.synchronize()
    stages = (polar_stage_times if args.model in POLAR_MODELS
              or args.model.startswith("nusc-polarstream-seg")
              else seg_stage_times if args.model in SEG_MODELS
              else sh_stage_times if args.model in SH_MODELS
              else stage_times)
    out = {"card": chip_smoke.gpu_name_and_power_limit(),
           "torch": torch.__version__, "model": args.model,
           "use_block_kernel": args.use_block_kernel,
           "stage_ms": stages(det, ex, args.frames),
           "trace": trace(lambda: det.predict(ex), args.out,
                          args.model.replace("flagship", "frame"))}
    if args.model == "sparse":
        with torch.no_grad():
            out["backbone_trace"] = trace(
                lambda: backbone_stage(det.module, ex), args.out,
                "sparse_backbone")
    if args.model.startswith("pp"):
        with torch.no_grad():
            out["pillar_trace"] = trace(lambda: backbone_stage(
                det.module, ex), args.out, args.model + "_pillars")
        out["pillar_parts"] = pillar_parts(det.module, ex)
    head = det.module.bbox_head
    if args.model.startswith("nusc-") and head is not None and hasattr(
            getattr(head, "task0", None), "feature_adapt_cls"):
        with torch.no_grad():
            x = torch.relu(head.Conv_0(det.module.neck(backbone_stage(
                det.module, ex))))
            out["deform_conv_shape"] = tuple(x.shape)
            out["deform_conv_trace"] = trace(
                lambda: head.task0.feature_adapt_cls(x), args.out,
                args.model + "_deform_conv")
    return out


@torch.no_grad()
def pillar_parts(mod, ex):
    """The pillar stage's parts on the frame's points, device ms
    (``chip_smoke.device_ms``): the pillarizer (``dynamic_voxelize`` on
    the pillar grid), the PFN on its output, the scatter, and each PFN
    layer's pooled max (``scatter_reduce`` amax into the batch's pillar
    slots) on that layer's rows, beside the max's bound by bytes (its
    rows and slot ids read once, the pooled rows written once)."""
    from partner_tpu_torch.models.pillar import _segment_max, pp_scatter

    pts, mask = ex["points"], ex["points_mask"]
    b, p, c = pts.shape
    v = mod.max_pillars
    vox = mod.pillarize(pts, mask)
    pv = vox["point_voxel"].long()
    seg = torch.where(pv < v, pv + torch.arange(b, device=pts.device)[
        :, None] * v, b * v).reshape(b * p)
    args = (pts.reshape(b * p, c), mask.reshape(b * p), seg,
            vox["coords"].reshape(b * v, 3), b * v)
    rows = {}
    hooks = [getattr(mod.reader, f"pfn{i}_bn").register_forward_hook(
        lambda m, a, o, i=i: rows.setdefault(i, torch.relu(o)))
        for i in range(len(mod.reader.num_filters))]
    feats = mod.reader(*args)
    for h in hooks:
        h.remove()
    out = {"pillarize_ms": chip_smoke.device_ms(
               lambda: mod.pillarize(pts, mask)),
           "pfn_ms": chip_smoke.device_ms(lambda: mod.reader(*args)),
           "scatter_ms": chip_smoke.device_ms(lambda: pp_scatter(
               feats.reshape(b, v, -1), vox["coords"], vox["mask"],
               mod.grid_size)),
           "pillars": vox["mask"].sum(1).tolist(), "rows": b * p}
    valid = seg < b * v
    for i, x in rows.items():
        xm = torch.where(valid[:, None], x, float("-inf"))
        nbytes = (xm.numel() * 4 + seg.numel() * 8
                  + (b * v + 1) * x.shape[1] * 4)
        out[f"pooled_max{i}_ms"] = chip_smoke.device_ms(
            lambda xm=xm: _segment_max(xm, seg, b * v + 1))
        out[f"pooled_max{i}_bound_ms"] = chip_smoke.bound(
            {"flops": {}, "bytes": nbytes})[0]
    return out


def conv_work(x, mod):
    """FLOPs and bytes of a ``Conv2d`` or ``ConvTranspose2d`` of the port
    on its NHWC input ``x``: float32 products, the input, weight and
    output each once."""
    from partner_tpu_torch.models.layers import ConvTranspose2d

    from partner_tpu_torch.models.rpn_stream import DeblockTranspose

    w = mod.weight
    b, h, wd, _ = x.shape
    if isinstance(mod, ConvTranspose2d):   # a cell -> s x s
        # (I, O, s, s); a stream neck's deblock keeps (O, I, s, s)
        cout = w.shape[0 if isinstance(mod, DeblockTranspose) else 1]
        flops = 2 * b * h * wd * w.numel()
        out = b * h * wd * mod.stride ** 2 * cout
    elif mod.padding == 0:                 # VALID, on a padded input
        k = w.shape[-1]
        ho, wo = (h - k) // mod.stride + 1, (wd - k) // mod.stride + 1
        flops = 2 * b * ho * wo * w.numel()
        out = b * ho * wo * w.shape[0]
    else:                                  # (O, I, k, k), stride s
        ho, wo = -(-h // mod.stride), -(-wd // mod.stride)
        flops = 2 * b * ho * wo * w.numel()
        out = b * ho * wo * w.shape[0]
    return {"flops": {"f32": flops},
            "bytes": 4 * (x.numel() + w.numel() + out)}


def kernel_names(run):
    """{kernel name: device ms} of one traced call of ``run``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name[:90]] = names.get(e.name[:90], 0.0) + \
                e.device_time / 1e3
    return names


def profile_rpn_convs(dev, args):
    """Each conv of the frame's RPN on the input the frame hands it (the
    BEV of the model's example), device ms (``chip_smoke.device_ms``) and
    the kernels cuDNN runs, with ``cudnn.benchmark`` off as in the port:
    as the port calls it (an NHWC tensor permuted to an NCHW view, so
    channels-last strides, beside an NCHW-contiguous weight), on the same
    values copied NCHW-contiguous, channels-last with the weight
    channels-last too, one sample a call (``per_sample``), and with TF32
    allowed (``tf32``: another precision, for scale only)."""
    from partner_tpu_torch.models.layers import Conv2d, ConvTranspose2d

    det, ex = build_frame(dev, args)
    mod = det.module
    convs = {f"neck.{n}" if args.model.startswith("pp") else n: m
             for n, m in mod.neck.named_children()
             if n.startswith(("Conv_", "ConvTranspose_"))}
    if args.model in POLAR_MODELS or args.model in SH_MODELS:
        # the stream neck's convs at sector 0 (STROBE: sweep 0)
        convs = {n: m for n, m in mod.neck.named_modules()
                 if isinstance(m, (Conv2d, ConvTranspose2d))}
    if args.model.startswith("pp"):
        convs.update({f"bbox_head.{n}": m for n, m in
                      mod.bbox_head.named_modules()
                      if isinstance(m, (Conv2d, ConvTranspose2d))})
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: inputs.setdefault(name, a[0].detach()))
        for name, m in convs.items()]
    with torch.no_grad():
        if args.model in POLAR_MODELS:
            p, v = mod.sector_inputs(ex["points"], ex["points_mask"])[0]
            mod.neck(mod.encode_sector(p, v), None)
        elif args.model in SH_MODELS:
            mod(ex)
        else:
            x = mod.neck(backbone_stage(mod, ex))
        if args.model.startswith("pp"):
            mod.bbox_head(x)
    for h in hooks:
        h.remove()
    torch.backends.cudnn.benchmark = False
    out = {"card": chip_smoke.gpu_name_and_power_limit(),
           "torch": torch.__version__, "model": args.model,
           "cudnn": torch.backends.cudnn.version(), "convs": {}}
    with torch.no_grad():
        for name, x in inputs.items():
            mod = convs[name]
            cf = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            w = mod.weight
            routes = {"port": lambda: mod(x), "nchw": lambda: mod(cf)}
            if isinstance(mod, Conv2d):
                wcl = w.detach().to(memory_format=torch.channels_last)

                def both_cl(mod=mod, x=x, w=w, wcl=wcl):
                    mod.weight.data = wcl
                    try:
                        return mod(x)
                    finally:
                        mod.weight.data = w.detach()
                routes["channels_last"] = both_cl

            def per_sample(mod=mod, x=x):
                return torch.cat([mod(x[i:i + 1]) for i in range(len(x))])

            def tf32(mod=mod, x=x):
                torch.backends.cudnn.allow_tf32 = True
                try:
                    return mod(x)
                finally:
                    torch.backends.cudnn.allow_tf32 = False
            routes.update(per_sample=per_sample, tf32=tf32)
            r = {"input": list(x.shape), "weight": list(w.shape),
                 "stride": getattr(mod, "stride", None)}
            r["bound_ms"], r["bound_by"] = chip_smoke.bound(
                conv_work(x, mod))
            for route, fn in routes.items():
                r[f"{route}_ms"] = chip_smoke.device_ms(fn)
                r[f"{route}_kernels"] = kernel_names(fn)
            out["convs"][name] = r
            print(f"{args.model} RPN {name}: " + ", ".join(
                f"{k} {v!r}" for k, v in r.items() if k.endswith("ms")),
                flush=True)
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
    ap.add_argument("--part", default="frame", choices=["frame", "rpn"],
                    help="rpn: each RPN conv of the frame alone, by "
                    "memory layout")
    ap.add_argument("--model", default="flagship",
                    choices=["flagship", "centerpoint", "centerpoint-velo",
                             "sparse", "nusc-dcn", "nusc-01voxel",
                             "nusc-dcn_flip", "nusc-singlehead", "pp",
                             "pp-two_cls"] + list(POLAR_MODELS)
                    + list(SEG_MODELS) + list(SH_MODELS),
                    help="the frame's model (the train step: flagship)")
    ap.add_argument("--batch", type=int, default=1,
                    help="sweeps a frame (the PointPillars models and "
                    "nusc-singlehead)")
    args = ap.parse_args()
    if args.train and (args.model != "flagship" or args.part != "frame"):
        sys.exit("torch_frame_profile: --train profiles the flagship only")
    if args.batch != 1 and not (args.model.startswith("pp")
                                or args.model == "nusc-singlehead"
                                or args.model in POLAR_MODELS
                                or args.model in SEG_MODELS
                                or args.model in SH_MODELS):
        sys.exit("torch_frame_profile: --batch is for the PointPillars "
                 "models, nusc-singlehead, the PolarStream, seg, HAN and "
                 "STROBE models")
    if args.part == "rpn" and args.model in SEG_MODELS:
        sys.exit("torch_frame_profile: --part rpn is not wired for the "
                 "seg models")
    if not torch.cuda.is_available():
        sys.exit("torch_frame_profile: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from partner_tpu_torch.models import build_detector

    dev = torch.device("cuda", 0)
    if args.train:
        result = profile_train(dev, args)
    elif args.part == "rpn":
        result = profile_rpn_convs(dev, args)
    else:
        result = profile_frame(dev, args)
    name = ("train_profile.json" if args.train
            else f"{args.model.replace('flagship', 'frame')}"
            f"{'_rpn' if args.part == 'rpn' else ''}"
            f"{f'_b{args.batch}' if args.batch != 1 else ''}_profile.json")
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
