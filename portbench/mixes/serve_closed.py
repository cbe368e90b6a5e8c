"""serve_closed: one client hands the served path one sweep at a time and
waits for its detections before it sends the next (a closed loop at batch
1). The traffic file gives the sweep (``points`` in ``rows``), the boxes
a sweep holds at most (``max_boxes``), the ``pool`` of seeded sweeps
staged in pinned host memory and cycled, the ``warmup_frames``, how many
frames are checked (``check_frames``, drawn from the seed among the first
``check_within``), and a traced run's profiled slice of ``trace_frames``
after the window (:func:`probe.traced`).

A frame is what the port's ``dist_test`` does with a sweep for a
voxel-input detector: the sweep's buffer copied to the card, voxelized
there (``ops.voxelize.DeviceVoxelizer``), ``predict``, the detections
copied back to the host. Its latency runs from the start of the copy in
to the detections on the host.

End-to-end: ``serve_fps`` (frames completed in the window over the
window's seconds), ``serve_p95_ms`` (the 95th percentile of every frame's
latency in the window) and ``setup_s``."""

import time
import types

import numpy as np
import torch

from portbench import (check, harness, inputs, probe, reference,
                       yardstick)


def make_pool(run):
    cfg, p = run.config, run.traffic
    vg = cfg["model"]["bbox_head"]["voxel_generator"]
    n_features = cfg["model"]["backbone"]["num_input_features"]
    rng = run.rng("sweeps")
    return [inputs.serve_sweep(rng, vg, p["points"], p["rows"],
                               p["max_boxes"], n_features)[:2]
            for _ in range(p["pool"])]


def served(det, voxelizer_cls, cfg, device):
    """The served path's objects under the names the configuration's
    ``stages`` use: ``det``, and ``vox``, the voxelizer at the
    configuration's serving capacity."""
    vg = cfg["model"]["bbox_head"]["voxel_generator"]
    return types.SimpleNamespace(det=det, vox=voxelizer_cls(
        vg, device, reference.serving_capacity(vg)))


def serve_frame(root, pts, mask, device, spans):
    """One served frame of ``root`` (:func:`served`) -> the detections on
    the host."""
    with spans.mark("transfer_in"):
        ex = {"points": pts.to(device, non_blocking=True),
              "points_mask": mask.to(device, non_blocking=True)}
    ex.update(root.vox(ex["points"], ex["points_mask"]))
    out = root.det.predict(ex)
    with spans.mark("transfer_out"):
        return {k: v.to("cpu") for k, v in out.items()}


def checked_frames(run):
    """The frames whose output is checked: ``check_frames`` of the first
    ``check_within``, each of another sweep, drawn from the seed."""
    p = run.traffic
    rng = run.rng("check")
    sweeps = rng.choice(p["pool"], p["check_frames"], replace=False)
    cycles = p["check_within"] // p["pool"]
    return sorted(int(s + p["pool"] * rng.randint(cycles)) for s in sweeps)


def run(run):
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    cfg, p, dev = run.config, run.traffic, run.device
    cuda = torch.device(dev).type == "cuda"
    with run.setup.part("build"):
        det = harness.build_program(cfg, dev, run.seed)
        root = served(det, DeviceVoxelizer, cfg, dev)
    with run.setup.part("inputs"):
        pool = make_pool(run)
        staged = [tuple(torch.from_numpy(a).pin_memory() if cuda
                        else torch.from_numpy(a) for a in sweep)
                  for sweep in pool]
    spans = probe.Spans(dev)
    kernels = probe.Kernels(cfg["kernels"])
    targets = checked_frames(run)
    taps = probe.Taps(targets)
    taps.install(root, cfg["stages"]["serve"])
    if run.trace:
        spans.install(root, cfg["stages"]["serve"])

    with run.setup.part("warmup"):
        t0 = time.perf_counter()
        for i in range(p["warmup_frames"]):
            serve_frame(root, *staged[i % len(staged)], dev, spans)
        warm_s = (time.perf_counter() - t0) / p["warmup_frames"]
    kernels.reset()
    counters = probe.Counters(cfg["counters"])
    counters.reset()
    before = harness.gpu_readings()

    outputs, lat, ends = {}, [], []
    cpu_s = time.process_time()
    t_start = time.perf_counter()
    setup_s = t_start - run.setup.t0
    i = 0
    while True:
        spans.begin()
        taps.frame = i
        t0 = time.perf_counter()
        host = serve_frame(root, *staged[i % len(staged)], dev, spans)
        t1 = time.perf_counter()
        spans.end()
        lat.append(t1 - t0)
        ends.append(t1 - t_start)
        if i in targets:
            outputs[i] = host
        i += 1
        if ends[-1] >= run.seconds:
            break
    taps.frame = None
    frames, window_s = i, ends[-1]
    host_line = harness.host_share(time.process_time() - cpu_s, window_s)
    launches = kernels.counts()
    counts = counters.read()
    after = harness.gpu_readings()
    device = harness.device_info(dev, run.cell.chips)

    lat_ms = np.array(lat) * 1e3
    fifth = window_s / 5
    first = sum(1 for e in ends if e <= fifth) / fifth
    last = sum(1 for e in ends if e > window_s - fifth) / fifth
    want = cfg["launches"]["serve"]
    per_frame = {k: v / frames for k, v in launches.items()}
    harness.log(f"card: before the window {before}; after {after}")
    harness.log(host_line)
    harness.log("setup_s parts: " + ", ".join(
        f"{k} {v!r}" for k, v in run.setup.parts.items())
        + f"; total {setup_s!r}; warm-up frame {warm_s * 1e3!r} ms")
    route = "as the route" if per_frame == want else "NOT the route"
    harness.log(f"hand-kernel launches a frame {per_frame} (route: {want}, "
                f"{route})")
    harness.log(f"window: {frames} frames in {window_s!r} s; fps in the first "
                f"fifth {first!r}, last fifth {last!r}; latency ms median "
                f"{float(np.median(lat_ms))!r}, max {float(lat_ms.max())!r}")
    harness.log("frames each second of the window: "
                f"{np.bincount(np.array(ends, int)).tolist()}")
    harness.log(f"peak device memory {device['memory_peak_bytes']} bytes")
    harness.log(f"program counters a frame "
                f"{ {k: v / frames for k, v in counts.items()} }")
    trace = None
    if run.trace:
        trace = probe.traced(
            lambda k: serve_frame(root, *staged[(frames + k) % len(staged)],
                                  dev, spans),
            p["trace_frames"], dev)

    spans_ms, kept = spans.totals()
    records = {"frames": frames, "window_s": window_s, "latency_ms": lat_ms,
               "spans": {k: v / kept for k, v in spans_ms.items()} if kept
               else {},
               "trace": trace,
               "counters": {k: v / frames for k, v in counts.items()}}
    breakdown = harness.traced_device(device, trace)

    e2e = {"serve_fps": frames / window_s,
           "serve_p95_ms": float(np.percentile(lat_ms, 95)),
           "setup_s": setup_s}
    del det, root, staged
    if cuda:
        torch.cuda.empty_cache()
    from portbench.reference.ptt.ops.voxelize import DeviceVoxelizer as Vox

    ref = served(harness.build_reference(cfg, dev, run.seed), Vox, cfg, dev)
    records["flops"] = frame_flops(cfg, ref, pool, frames, dev)
    checks = judge(run, ref, targets, taps.kept, outputs)
    return harness.Outcome(e2e, records, frames, 0, checks, device,
                           breakdown)


def frame_flops(cfg, ref, pool, frames, device):
    """FLOPs a frame of the window, whose frames cycle through ``pool``:
    the configuration's frozen dense part plus each sweep's sparse convs
    (:func:`yardstick.sparse_flops`, over the reference's voxels and
    maps), averaged over the window's frames."""
    grid = ref.det.module.grid_size
    sparse = []
    with torch.no_grad():
        for pts, mask in pool:
            vox = ref.vox(torch.from_numpy(pts).to(device),
                          torch.from_numpy(mask).to(device))
            sparse.append(yardstick.sparse_flops(ref.det.module.backbone,
                                                 vox, grid))
    total = sum(sparse[i % len(pool)] for i in range(frames))
    return cfg["flops"]["frame_dense"] + total / frames


def judge(run, ref, targets, kept, outputs):
    """The checked frames against the reference (:func:`served` over the
    reference detector), stage by stage, and the sites the program's
    sparse backbone dropped at its capacities: [(name, value, limit)]; a
    frame due to be checked that the window did not reach reads inf."""
    cfg = run.config
    limits, stages = cfg["limits"]["serve"], cfg["stages"]["serve"]
    done = set(outputs) == set(targets)
    errs = {n: 0.0 if done else float("inf") for n in stages
            if n != "decode_nms"}
    mismatch, dropped = 0, 0 if done else float("inf")
    with reference.exact_float32(), torch.no_grad():
        for i in sorted(outputs):
            for name in errs:
                args, kwargs, got = kept[i][name]
                want = probe.resolve(ref, stages[name])(*args, **kwargs)
                errs[name] = max(errs[name], check.rel_err(got, want))
            args, kwargs, _ = kept[i]["decode_nms"]
            mismatch += check.det_mismatch(outputs[i], ref.det.decode(
                *args, **kwargs))
            dropped += check.sites_dropped(ref.det.module.backbone,
                                           kept[i]["voxelize"][2],
                                           ref.det.module.grid_size)
    harness.log(f"checked frames {sorted(outputs)}")
    return [(f"rel_err.{n}", e, limits[n]) for n, e in errs.items()] + [
        ("det_mismatch", mismatch, limits["decode_nms"]),
        ("sites_dropped", dropped, limits["sites"])]
