#!/usr/bin/env python3
"""Smoke run of partner_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA; it uses card 0. Phases:

1. environment: the card's ``nvidia-smi`` name and power limit, the torch
   and CUDA versions, and the ``nvcc`` build of the kernels in
   ``partner_tpu_torch/csrc`` (time, registers, shared memory);
2. kernels: each hand-written kernel (stem, window attention, whole Swin
   block, scatter-max in bf16 and float32, and the scatter-max's
   gradient) against its plain PyTorch twin on the same inputs at the
   flagship frame's shapes, with the error bound stated below; the time
   of each (per call, and on the device alone: :func:`call_and_device_ms`)
   beside its twin's, beside the one PyTorch call that computes the same
   function where there is one (timed here only, never called by the
   port), and beside its bound, the least time the card could take for
   the work (:func:`kernel_work`, :func:`bound`); for the stem also the
   count of outputs not equal to its twin, for the scatter-max the time of
   its canvas fill alone; the stem also at C_in 11 over 432,000 rows, the
   two-sweep CenterPoint config's width and buffer, and with the
   scatter-max at a train step's batch of 4 (4 x 180,000 rows), where the
   frozen two-stage step runs them;
3. frame: the flagship PARTNER detector
   (``configs/waymo/waymo_partner_36epoch.py``) at full width in bf16,
   random weights from a seeded ``torch.Generator`` with every norm
   parameter and statistic randomized, driven through
   ``E2EDetector.predict`` on a synthetic 180,000-point sweep in a
   216,000-row buffer, once on each route of the head's Swin blocks (per
   block with the attention kernel; whole block with the block kernel,
   ``build_detector(..., use_block_kernel=True)``): the kernels' launch
   counts over each route's frames, the median frame time, finite
   outputs, and NMS that kept boxes;
4. train: the flagship train step (``make_train_step`` over
   ``E2EDetector.loss``: BatchNorm batch statistics, DropPath, the five
   set losses over the auction matcher, backward, one-cycle Adam) at full
   width and the config's batch of 4, on synthetic 150,000-point sweeps
   with up to 64 vehicle boxes and their vote maps: one warm-up step and
   TRAIN_STEPS timed ones, the peak memory, finite losses and gradients,
   the scatter-max kernel launched once per step and the stem, attention
   and block kernels never (train mode routes around them, as JAX does);
5. reference: the flagship widths on a small grid, the card's frame (bf16,
   CUDA kernels) against the CPU's (float32, plain twins) with the same
   weights and points, the head on both routes; then one train step on
   the same grid, the card in bf16 and in float32 each against the CPU in
   float32: the matches, each loss term and the gradients of each
   top-level module;
6. eval: the seeded random weights saved as a port checkpoint, and the
   port's evaluation entry point (``partner_tpu_torch.tools.dist_test``)
   over a synthetic Waymo val set of EVAL_FRAMES 180,000-point sweeps with
   32-64 vehicle boxes each, on the card: each frame's kept boxes
   bit-equal to a direct ``predict`` of the same collated batch, the
   kernels' launch counts, finite Waymo metrics, the middle-third FPS,
   the host time per frame beyond ``predict``, ``predict``'s time against
   the same frames predicted with no loader thread running, and the card's
   SM clock and power by third of the frames (``nvidia-smi`` every 100 ms);
7. static RPE: the per-block route at full width after
   ``E2EDetector.prepare_inference``, cached frames (no attention kernel)
   and live frames taking turns: the cache's bytes, each mode's launches,
   median frame ms and device busy; the cached frame's head maps and kept
   boxes against the live plain frame (the fill pass's path) and the live
   kernel frame, and the same readings of planted wrong tables, each of
   which must break a bound.
8. train CLI: ``partner_tpu_torch.tools.train.main`` on the card at full
   width and batch 4 over 8 synthetic 150,000-point Waymo frames written
   as the converter's frame and anno pickles, their infos and GT database
   prepared by the port's ``create_data`` (``waymo_data_prep``,
   ``create_groundtruth_database``), with GT-AUG from that database (the
   flagship's Vehicle=15 quota, its filters and augmentations): 4 steps
   in 2 epochs with a checkpoint and a validation after each, then a run
   to step 6 that resumes from ``latest`` at step 4 with the checkpoint's
   Adam count and moments. Readings: each step's loss terms, gradient
   norm and phase times (finite), the median step time and the data share,
   GT-AUG boxes inserted per sample, peak memory, each validation's
   metrics, the kernels' launches per train step and per validation frame,
   and the host data path alone (ms a sample in one thread, the loader's
   batches a second with its threads);
9. CenterPoint: the Waymo CenterPoint family
   (``configs/waymo/waymo_centerpoint_voxelnet_36epoch.py``, ``VoxelNet``
   with the 3D trunk and ``CenterHead``) at full width, random weights with
   norms randomized: the frame on the 180,000-point sweep (median ms,
   device busy and launches a frame, the stem and scatter-max once a
   frame, kept boxes, finite maps); the backbone BEV and each head map of
   the card against the CPU on SMALL_GRID; the two-sweep velocity config
   (8 features, the stem at C_in 11) on 2 x 180,000 points in 432,000 rows
   (median ms, finite ``vel`` map); the train step at batch 4 with center
   targets (median ms, peak memory, finite per-task losses, the scatter-max
   once a step); ``dist_test`` from a port checkpoint over 10 synthetic
   3-class frames (middle-third FPS, finite per-class metrics) and two
   train-CLI steps at batch 4 from that set (finite losses, one
   checkpoint);
10. two-stage: the frozen Waymo two-stage CenterPoint
   (``configs/waymo/two_stage/waymo_centerpoint_voxelnet_two_stage_bev_
   5point_ft_6epoch_freeze.py``: the VoxelNet first stage, 500 proposals a
   frame, 5 BEV samples each, the RoI head 2561 -> 256 -> 256) at full
   width, random weights with norms randomized: its frame on the
   180,000-point sweep taking turns with the one-stage frame of the same
   first stage (median ms, device busy and launches a frame, the stem and
   scatter-max once a frame, the refine stage's device ms by CUDA events,
   kept boxes, a repeat bit-equal); the two-sweep velocity config on 2 x
   180,000 points (the stem at C_in 11, the velocity columns the first
   stage's); the frozen train step at batch 4 with planted positive
   proposals (median ms, peak memory, finite RoI losses, the first stage
   bit-unchanged and every RoI parameter moved, the kernels once a step);
   then on the card's host the port's ``create_data`` over fake Waymo
   frames at the TOP lidar's size (ms a frame for the converter, the
   infos and the GT database), a seeded one-stage checkpoint, two
   train-CLI steps of the frozen config from it through ``pretrained``
   with GT-AUG from that database (the first stage bit-equal to the
   checkpoint's afterwards), and ``dist_test`` over those frames, each
   bit-equal to a direct ``predict``;
11. serving: the voxel-input contract and the serving tools at full
   width. The flagship frame through ``features`` (``dynamic_voxelize``
   on the card at the config's 150,000-voxel capacity, the reader,
   ``PolarDenseFHD.forward``) taking turns with the point-path frame on
   the same weights: median ms, device busy and launches a frame, the
   voxelizer's device time and launches, voxels found against the
   capacity, a repeated frame bit-equal; ``dynamic_voxelize`` of the full
   sweep on the card against the CPU, and the backbone's voxel path on
   SMALL_GRID against the CPU in float32; ``single_inference`` from a
   port checkpoint (ms and detections a frame, each frame bit-equal to a
   direct ``predict``, a repeated frame bit-equal, ``--once`` writing the
   same detections); ``multi_sweep_inference --nsweeps 2`` with the
   two-sweep velocity CenterPoint config over SERVE_FRAMES timed frames
   with ego poses (middle-third FPS, launches, the last frame bit-equal to
   a direct ``predict``). The kernel phase holds the stem and the
   scatter-max at the voxel path's shapes too;
12. native: the port's C++ host library built on the card's host (the
   run fails where it is not available), its three functions bit-equal to
   the numpy bodies at train sizes, and their host ms both ways; the
   train-CLI phase reads the host data path with and without it;
13. sparse / reference checkpoint: the flagship with ``model["backbone"]``
   replaced by the reference's ``SpMiddleResNetFHD``, its weights from a
   seeded synthetic det3d checkpoint converted by
   ``tools.convert_checkpoint`` and ``train.torch_convert``, at full width:
   ``predict`` through ``dynamic_voxelize`` on both head routes (median
   ms, launches, device busy, the backbone's ms, peak memory, repeats
   bit-equal); the sparse backbone's maps and BEV on SMALL_GRID against
   the CPU, and rows permuted; ``dist_test --input voxels`` from a
   ``modelzoo://`` name, bit-equal to ``predict`` (:func:`sparse_phase`).
   The kernel phase also runs the whole-block case at BLOCK_DRAWS more
   draws against the float32 block (:func:`block_draws`).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure raises before it, so the
exit code is then non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "waymo", "waymo_partner_36epoch.py")
SEED = 0
N_POINTS = 180_000           # a realistic Waymo sweep, as bench.py drives it
FRAMES = 10                  # timed frames per route after one warm-up
SMALL_GRID = (256, 512, 40)  # reference phase: BEV 64 (az) x 32 (r)
TRAIN_POINTS = 150_000       # bench.py's train sweep ...
TRAIN_ROWS = 180_000         # ... in a 180,000-row buffer
MAX_BOXES = 64               # gt slots per sample, up to 64 boxes filled
TRAIN_STEPS = 5              # timed train steps after one warm-up
# val frames through dist_test (cut this first). The FPS is taken over the
# middle third, frames 10-19, clear of a fresh detector's first frames,
# which can run slower (52-59 ms against 42.6 in one run on an NVIDIA H100
# 80GB HBM3 at 700 W); 6 frames put the window on frames 2-3.
EVAL_FRAMES = 30
EVAL_ROWS = 216_000          # dist_test --max_points: bench.py's buffer

# Kernel vs plain twin, both bf16 on the card: |kernel - plain| <=
# KERNEL_TOL * (1 + |plain|), two bf16 ulps. Both accumulate in f32 but in
# another order, which can flip the bf16 rounding of a stem hidden value,
# an attention probability or a block intermediate. The scatter-max picks
# one of its inputs, so it must be exact (bound 0).
KERNEL_TOL = 2.0 ** -7
# more draws of the whole-block case (:func:`block_draws`): the seeds of
# their generators
BLOCK_DRAWS = (101, 102, 103)
# Reference phase, card vs CPU (float32, plain twins), stage by stage,
# each stage fed the CPU's input: relative RMS error ||card - cpu|| /
# ||cpu|| per output. The bf16 stages (backbone with the stem kernel; RPN
# and head with the attention kernel) round to 8 bits at each of ~20
# layers: 0.3-0.9% measured on the CPU in bf16, bound 2%. The SetBlock
# computes in float32 on both sides, bound 1%: only a keypoint top-k near
# tie broken the other way, a discrete choice, could move it that far.
REF_BF16 = 0.02
REF_F32 = 0.01
# Static-RPE phase, cached frames against two live frames, all bf16 on the
# card, by the largest relative RMS error over the head maps and the share
# of the live frame's kept boxes that have a cached kept box within
# STATIC_MATCH_M.
# - Against the live plain frame (the fill pass's path: the same plain
#   attention, the RPE rebuilt each frame and the region mask added apart):
#   the same arithmetic but for where the -100 mask is added, so the maps
#   agree to STATIC_PLAIN_TOL and every kept box matches.
# - Against the live kernel frame: the kernel rounds otherwise than the
#   plain attention (bf16 probabilities, its own summation order), and the
#   two blocks and the heads carry that on: 2.2% on the card at full grid
#   (height, the map of smallest magnitude; a table with the RPE in float32,
#   as the kernel evaluates it, reads 2.1%, so not the RPE's precision),
#   0.3-1.6% on the CPU (SMALL_GRID, bf16, seeds 0-2). A near-tie score or
#   suppression may flip and cascade through the greedy NMS: 0.974 of the
#   kept boxes matched on the card (the CPU 0.986-0.994); the matched boxes
#   to REF_BF16.
# Planted faults must each break a bound. On the card (NVIDIA H100 80GB
# HBM3, 700 W) the mask not folded in read 12.4% / 0.848 against the kernel
# frame, the windows in column-major order 21.3% / 0.790, the table of
# other weights 21.0% / 0.774: STATIC_MAP_TOL and STATIC_MATCH_SHARE sit
# between those and the sound 2.2% / 0.974. The RPE in float32 read 2.1% /
# 0.962, within the kernel-frame bounds; against the plain frame it read
# 2.2% / 0.964, where the sound table reads 0.0 / 1.0 (bit-equal), so
# STATIC_PLAIN_TOL and the exact match catch it.
STATIC_PLAIN_TOL = 1e-3
STATIC_MAP_TOL = 0.05
STATIC_MATCH_M = 0.1
STATIC_MATCH_SHARE = 0.95
# Train reference: one step on SMALL_GRID, batch 2, the card against the CPU
# in float32 (plain twins) with the same weights, example and dropout draws,
# the card once in the config's bf16 and once in float32 (the scatter
# kernel has a float32 entry for this). Per loss term |card - cpu| / |cpu|;
# per top-level module ||grad card - grad cpu|| / ||grad cpu|| and the norm
# ratio. Upstream of the head (backbone, SetBlock, RPN) the train-mode
# network is chaotic at random weights: a perturbation of its activations
# grows ~1.14x per conv + BatchNorm(batch statistics) + ReLU layer, and each
# ReLU whose input changes sign moves the gradient. Measured on the CPU
# (seeds 4, 11, 23) before the float32 card run, those gradients move 0.7-1.0%
# when every weight is scaled by 1 + 1e-6 in float32 and 0.2-1.35% under
# another summation order (3 threads against 8), but 100-124% under the
# same 1e-6 scaling in bf16 (1-ulp rounding flips) and 111-128% in bf16
# against float32: bf16 leaves them uncorrelated (sqrt(2) = 1.41 for two
# unrelated gradients of equal norm), with their norms within 3-8%.
# So the direction upstream is held in float32, the bf16 run by its loss
# terms, head gradients and norm ratios.
# bf16 against float32 on the CPU: loss terms 0.0003-0.039 except loss_iou
# 0.016-0.34 (bf16 flips 5-8 of 16-26 matches while num_matched stays equal,
# and loss_iou averages over the matched pairs), the total loss
# 0.0019-0.0092, head gradient 0.084-0.115, norm ratios 0.946-1.078.
TRAIN_LOSS_TOL = {"loss": 0.03, "loss_iou": 0.6}
TRAIN_TERM_TOL = 0.1
TRAIN_GRAD_TOL = {"bbox_head": 0.25}   # upstream: norm ratio only
TRAIN_NORM_TOL = 1.25        # |log(norm card / norm cpu)| <= log(1.25)
# float32 against float32 on the CPU (the two perturbations above): loss
# terms <= 1.52e-5, head gradient <= 2.5e-4, upstream <= 0.0135, no match
# flipped. Bounds ~10x those, far under the 1.41 of an unrelated gradient.
TRAIN_F32_LOSS_TOL = 1.5e-4
TRAIN_F32_GRAD_TOL = {"backbone": 0.15, "attns": 0.15, "neck": 0.15,
                      "bbox_head": 0.0025}

def log(*args):
    print(*args, flush=True)


def gpu_name_and_power_limit():
    res = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip()


# The H100 SXM's published dense peaks (NVIDIA's data sheet, at the full
# 700 W): tensor-core bf16 and float32 outside the tensor cores, FLOP/s;
# HBM3, bytes/s.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def kernel_work(name, *args):
    """FLOPs by type and bytes of one call of kernel ``name`` on the
    arguments its wrapper takes: every input byte read once, every output
    byte written once, and the products' FLOPs (2 a multiply-add; the
    elementwise work beside them is not counted). Where the work depends
    on the data, what these inputs need: the scatter-max reads the rows
    its mask keeps. -> {"flops": {"bf16": n, "f32": n}, "bytes": n}"""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    if name == "stem":
        x, mask, w1, a1, b1, w2, a2, b2 = args
        b, cin, p = x.shape
        f1, f2 = w1.shape[0], w2.shape[0]
        return {"flops": {"bf16": 2 * b * p * (f1 * cin + f2 * f1)},
                "bytes": nbytes(*args) + b * f2 * p * x.element_size()}
    if name == "swin_attn":
        q, k, v, pos, mask, w1, b1, w2, b2, tau = args
        nw, nh, t, hd = q.shape
        hid = w1.shape[1]
        return {"flops": {"bf16": 2 * 2 * nw * nh * t * t * hd,
                          "f32": 2 * nw * t * t * (2 * hid + hid * nh)},
                "bytes": nbytes(*args) + nbytes(q)}
    if name == "swin_block":
        x, vote, bias, params, nh, ws = args
        b, h, w, c = x.shape
        tokens, t = b * h * w, ws * ws
        m, hid = params["fc1_w"].shape[0], params["vote_w1"].shape[1]
        dense = 3 * c * c + c * c + m * c + c * m
        attn = (tokens // t) * nh * 2 * 2 * t * t * (c // nh)
        packed = [a for k, a in params.items() if k != "rpe"]
        return {"flops": {"bf16": 2 * tokens * dense + attn,
                          "f32": 2 * tokens * (3 * hid + hid * c)},
                "bytes": nbytes(x, vote, bias, *packed) + nbytes(x)}
    if name in ("scatter_max", "scatter_max_backward"):
        x, coords, mask, shape = args[:4]
        b, c, _ = x.shape
        kept = int(mask.sum())
        rows = kept * (c * x.element_size() + 3 * coords.element_size())
        cells = b * int(np.prod(shape)) * c * x.element_size()
        if name == "scatter_max":
            return {"flops": {}, "bytes": rows + nbytes(mask) + cells}
        # backward: canvas and cotangent read at the kept rows' cells, the
        # gradient of every row written
        gathered = 2 * min(kept * c * x.element_size(), cells)
        return {"flops": {}, "bytes": rows + nbytes(mask) + gathered
                + nbytes(x)}
    raise ValueError(name)


def bound(work):
    """(least ms the card could take for ``work``, "bytes" or
    "operations"): the larger of its bytes over the memory rate and, for
    each number type, its FLOPs over that type's peak (tensor cores and
    the float32 units run side by side)."""
    t_bytes = work["bytes"] / PEAK_BYTES * 1e3
    t_ops = max([f / PEAK_FLOPS[k] * 1e3 for k, f in work["flops"].items()]
                or [0.0])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, reps=20, warmup=3):
    """Device time of one call of ``fn``: ``reps`` calls back to back
    between two CUDA events, enqueued while the card sleeps, so that the
    host's time to enqueue them is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int(2e9 * (1.5 * reps * host_s + 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of one call of ``fn`` on the card, CUDA events around
    each call: the device time, or the host's time to enqueue the call
    where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_and_device_ms(key, fn):
    """{key: the per-call median (:func:`cuda_ms`), key with its "ms" read
    "device_ms": the device time (:func:`device_ms`)}. ``key`` names a
    per-call time, as the ``kernels`` line has always reported it."""
    return {key: cuda_ms(fn), key.replace("ms", "device_ms", 1): device_ms(fn)}


def compare(name, out, ref, tol):
    """Max |out - ref|; raises unless every element is within
    tol * (1 + |ref|) and finite."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out - ref).abs()
    n_bad = int((err > tol * (1 + ref.abs())).sum())
    max_err = float(err.max())
    log(f"{name}: max_abs_err {max_err!r} (bound {tol!r} * (1 + |plain|)), "
        f"{n_bad} elements beyond it")
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} elements beyond the bound")
    return max_err


def stem_terms(x, mask, w1, a1, b1, w2, a2, b2):
    """Per output of the stem, the magnitude of the terms it sums: |a2|
    (|w2| @ (|a1| |w1 @ x|)), in float32 (the hidden values are the ones
    each layer's bf16 rounding acts on)."""
    h = a1[:, None].abs() * (w1.float() @ x.float()).abs()
    return a2[:, None].abs() * (w2.float().abs() @ h) * mask[:, None, :]


def stem_twin_f64(x, mask, w1, a1, b1, w2, a2, b2):
    """The stem's plain twin with each layer's products summed in float64
    (then rounded to float32, as the twin's sums are): the twin in another
    summation order."""
    cdt, m, t = x.dtype, mask[:, None, :].to(x.dtype), x
    for w, a, b in ((w1, a1, b1), (w2, a2, b2)):
        acc = (w.double() @ t.double()).float()
        acc = (acc.to(cdt) * m).float() * a[:, None] + b[:, None]
        t = torch.relu(acc).to(cdt)
    return t


def compare_stem(name, out, ref, args, tol=KERNEL_TOL):
    """The stem held to its twin at real point magnitudes (the voxel
    path's rows carry rho, x and y up to 75 m): every output within
    ``tol`` (1 + |twin| + T) of the twin, T the magnitude of the terms it
    sums (:func:`stem_terms`), and under 0.1% of the outputs not equal.
    The kernel sums each product in another order than the twin, so a
    hidden value near 50 can round to the other side of a 0.25 bf16 step
    and move an output by 2^-7 of the terms it sums, where the (1 +
    |twin|) bound of :func:`compare` scales with the output alone. The
    twin against itself summed in float64 (:func:`stem_twin_f64`) is
    read by the same two rules beside it. Returns the max |out - twin|."""
    ref = ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    terms = stem_terms(*args)
    readings = {}
    for who, got in (("kernel", out.float()),
                     ("twin summed in float64", stem_twin_f64(*args).float())):
        err = (got - ref).abs()
        readings[who] = (
            float(err.max()),
            float((err / (1 + ref.abs() + terms)).max()),
            int((err > tol * (1 + ref.abs() + terms)).sum()),
            int((err > tol * (1 + ref.abs())).sum()),
            int((got != ref).sum()))
        log(f"{name}, {who} against the twin: max_abs_err "
            f"{readings[who][0]!r}, max err / (1 + |plain| + terms) "
            f"{readings[who][1]!r} (bound {tol!r}), {readings[who][2]} "
            f"elements beyond it ({readings[who][3]} beyond {tol!r} (1 + "
            f"|plain|)); {readings[who][4]} of {got.numel()} not equal")
    max_err, _, n_bad, _, n_diff = readings["kernel"]
    if n_bad or n_diff > 1e-3 * out.numel():
        raise AssertionError(f"{name}: {n_bad} elements beyond the bound, "
                             f"{n_diff} not equal")
    return max_err


def not_equal(name, out, ref):
    """{"not_equal": elements of ``out`` whose value differs from ``ref``,
    "elements": their number}: a kernel that sums in another order than its
    twin can flip a bf16 rounding within the bound."""
    n = int((out.float() != ref.float()).sum())
    log(f"{name}: {n} of {out.numel()} elements not equal to the twin")
    return {"not_equal": n, "elements": out.numel()}


# ------------------------------------------------------------------ kernels

def stem_case(gen, dev, cin=10, n_points=N_POINTS, batch=1):
    """Stem inputs at a point-path shape, bf16: the flagship's (1, 10,
    216,000) by default; (1, 11, 432,000) for the two-sweep CenterPoint
    config (cin 11, 2 x N_POINTS points); (4, 10, 180,000) for a train
    step's batch (``batch`` 4 of TRAIN_POINTS); the same 1.2x padding."""
    from partner_tpu_torch.ops import stem

    p = int(n_points * 1.2)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen)
    x = rnd(batch, cin, p).to(bf)
    mask = torch.rand(batch, p, generator=gen) < n_points / p
    w1 = (rnd(stem.F1, cin) * cin ** -0.5).to(bf)
    w2 = (rnd(stem.F2, stem.F1) * stem.F1 ** -0.5).to(bf)
    a1, a2 = (0.5 + torch.rand(f, generator=gen) for f in (stem.F1, stem.F2))
    b1, b2 = (0.2 * rnd(f) for f in (stem.F1, stem.F2))
    return [t.to(dev) for t in (x, mask, w1, a1, b1, w2, a2, b2)]


def voxel_case(gen, dev, cin=10, n_points=N_POINTS):
    """Stem and scatter-max inputs on the voxel path
    (``PolarDenseFHD.forward``): the dynamic voxels (capacity
    ``max_voxel_num``) of a synthetic sweep of ``n_points`` on the flagship
    grid, 7 point features (8 with ``cin`` 11, the two-sweep width)
    decorated by each voxel's place in its pooled cell, bf16 and
    channel-major, with stem weights drawn as :func:`stem_case` draws them
    -> (stem args, pooled coords (1, 3, V) int32 (z, az, r), canvas
    shape, voxels found)."""
    from partner_tpu_torch.ops import stem
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.utils.config import load_config

    vg = load_config(CONFIG)["voxel_generator"]
    pts, mask = synthetic_sweep(np.random.RandomState(SEED), vg["range"],
                                n_points, c=cin - 3)
    v = DeviceVoxelizer(vg, dev, vg["max_voxel_num"])(
        torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
    pools = torch.tensor([8, 4, 4], device=dev)
    frac = torch.remainder(v["coords"].float(), pools.float()) / pools - 0.5
    x = torch.cat([v["features"], frac], -1).to(torch.bfloat16)
    x = x.transpose(1, 2).contiguous()
    rnd = lambda *s: torch.randn(*s, generator=gen)
    bf = torch.bfloat16
    w1 = (rnd(stem.F1, cin) * cin ** -0.5).to(bf)
    w2 = (rnd(stem.F2, stem.F1) * stem.F1 ** -0.5).to(bf)
    a1, a2 = (0.5 + torch.rand(f, generator=gen) for f in (stem.F1, stem.F2))
    b1, b2 = (0.2 * rnd(f) for f in (stem.F1, stem.F2))
    args = [x, v["voxel_mask"].contiguous()] + [
        t.to(dev) for t in (w1, a1, b1, w2, a2, b2)]
    pooled = (v["coords"] // pools).to(torch.int32).transpose(1, 2)
    grid, _, _ = flagship_grid()
    canvas = (grid[2] // 8, grid[1] // 4, grid[0] // 4)
    return args, pooled.contiguous(), canvas, int(v["voxel_mask"].sum())


def attn_case(gen, dev, with_mask):
    """Window attention inputs at the flagship shape: 576 windows of the
    256 x 144 BEV, 4 heads, T = 64, hd = 64, the real cell positions and
    the real shifted-window mask."""
    from partner_tpu_torch.models import e2e_head, swin_vote

    grid, pc_range, ws = flagship_grid()
    og = e2e_head.head_offset_grid(grid, pc_range, 8)        # (256, 144, 2)
    pos = swin_vote.window_partition(torch.from_numpy(og)[None], ws)
    nw, nh, hd = pos.shape[0], 4, 64
    rnd = lambda *s: torch.randn(*s, generator=gen)
    q, k, v = (rnd(nw, nh, ws * ws, hd).to(torch.bfloat16) for _ in range(3))
    mask = None
    if with_mask:
        mask = torch.from_numpy(swin_vote.swin_attn_mask(
            og.shape[0], og.shape[1], ws, ws // 2))
    w1, b1 = 0.3 * rnd(2, 16), 0.1 * rnd(16)
    w2, b2 = 0.3 * rnd(16, nh), 0.1 * rnd(nh)
    tau = torch.clamp(0.5 + torch.rand(nh, generator=gen), min=0.01)
    return [None if t is None else t.to(dev).contiguous()
            for t in (q, k, v, pos, mask, w1, b1, w2, b2, tau)]


def flagship_grid():
    """(grid (n_r, n_az, n_z), pc_range, head window size) of the config."""
    from partner_tpu_torch.utils.config import load_config

    bh = load_config(CONFIG)["model"]["bbox_head"]
    vg = bh["voxel_generator"]
    grid = tuple(int(round((vg["range"][3 + i] - vg["range"][i])
                           / vg["voxel_size"][i])) for i in range(3))
    return grid, vg["range"], bh["HEAD_CONFIG"]["window_size"]


def block_case(gen, dev, shift):
    """Whole-block op inputs at the flagship shape: x (1, 256, 144, 256)
    bf16, a SwinVoteBlock with random weights and norms, the real cell
    positions and, for the shifted block, the real region mask, rolled as
    the whole-block route rolls them."""
    from partner_tpu_torch.models import e2e_head, swin_vote
    from partner_tpu_torch.models.layers import init_weights
    from partner_tpu_torch.ops import swin_block

    grid, pc_range, ws = flagship_grid()
    og = torch.from_numpy(e2e_head.head_offset_grid(grid, pc_range, 8))[None]
    h, w = og.shape[1:3]
    block = swin_vote.SwinVoteBlock(swin_block.C, swin_block.NH, ws,
                                    shift_size=shift, dtype=torch.bfloat16)
    init_weights(block, gen)
    randomize_norms(block, gen)
    block = block.to(dev)
    x = torch.randn(1, h, w, swin_block.C, generator=gen).to(torch.bfloat16)
    vote = torch.randn(1, h, w, 3, generator=gen)
    x, pos, vote = (torch.roll(t, (-shift, -shift), dims=(1, 2)).to(dev)
                    for t in (x, og, vote))
    mask = None
    if shift:
        mask = torch.from_numpy(swin_vote.swin_attn_mask(h, w, ws, shift))
        mask = mask.to(dev)
    params = swin_block.swin_vote_block_params(block, torch.bfloat16)
    bias = swin_block.block_bias_table(pos, mask, params["rpe"],
                                       torch.bfloat16, ws)
    return (x, vote, bias, params, swin_block.NH, ws), (pos, mask, params)


def block_draws(dev, card):
    """The whole-block case at BLOCK_DRAWS more seeded draws, each from a
    generator of its own, both shifts: every output beyond KERNEL_TOL (1 +
    |twin|) of the twin must lie within KERNEL_TOL (1 + |float32|) of the
    block computed in float32 with no rounding (the twin on a float32 x);
    where it does, the twin strayed by a bf16 rounding, not the kernel.
    -> per draw and shift (outputs beyond the twin's bound, of them beyond
    the float32 block's, the largest |kernel - twin|)."""
    from partner_tpu_torch.ops import swin_block

    found = {}
    for seed in BLOCK_DRAWS:
        for shift in (4, 0):
            gen = torch.Generator().manual_seed(seed)
            args, _ = block_case(gen, dev, shift)
            x, vote, bias, params, nh, ws = args
            out = swin_block.swin_vote_block(*args).float()
            plain = swin_block.swin_vote_block_plain(*args).float()
            exact = swin_block.swin_vote_block_plain(x.float(), vote, bias,
                                                     params, nh, ws)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError("swin_vote_block: non-finite output")
            off = (out - plain).abs() > KERNEL_TOL * (1 + plain.abs())
            off_f32 = (out - exact).abs() > KERNEL_TOL * (1 + exact.abs())
            n_off, n_both = int(off.sum()), int((off & off_f32).sum())
            worst = float((out - plain).abs().max())
            log(f"swin_vote_block seed {seed} shift {shift} on {card}: "
                f"{n_off} of {out.numel()} outputs beyond KERNEL_TOL of the "
                f"twin, {n_both} of them beyond it of the float32 block; max "
                f"|kernel - twin| {worst!r}, |kernel - float32| "
                f"{float((out - exact).abs().max())!r}, |twin - float32| "
                f"{float((plain - exact).abs().max())!r}")
            if n_both:
                raise AssertionError(
                    f"swin_vote_block seed {seed} shift {shift}: {n_both} "
                    "outputs beyond the bound of the twin and of float32")
            found[f"seed{seed}_shift{shift}"] = (n_off, n_both, worst)
    return found


def scatter_case(stem_out, dev, n_points=N_POINTS):
    """Scatter-max inputs at a point-path shape: the stem's (B, 64, rows)
    output and the canvas coords of B synthetic sweeps of ``n_points`` on
    the flagship grid (seeds SEED, SEED + 1, ...; rows past the sweep and
    out of range masked): the flagship's 216,000 rows by default, 432,000
    for the two-sweep CenterPoint config (2 x N_POINTS), 4 x 180,000 for a
    train step's batch."""
    grid, pr, _ = flagship_grid()
    n_r, n_az, n_z = grid
    canvas = (n_z // 8, n_az // 4, n_r // 4)                # (cz, cy, cx)
    sweeps = [synthetic_sweep(np.random.RandomState(SEED + i), pr, n_points)
              for i in range(stem_out.shape[0])]
    pts = np.concatenate([sw[0] for sw in sweeps])
    mask = np.concatenate([sw[1] for sw in sweeps])
    if pts.shape[1] != stem_out.shape[2]:
        raise ValueError(f"{pts.shape[1]} rows of coords for a stem output "
                         f"of {stem_out.shape[2]}")
    cell = np.asarray([(pr[3] - pr[0]) / n_r * 4, (pr[4] - pr[1]) / n_az * 4,
                       (pr[5] - pr[2]) / n_z * 8], np.float32)
    idx = np.floor((pts[..., :3] - np.asarray(pr[:3], np.float32)) / cell)
    idx = idx.astype(np.int32)                           # (B, P, 3) r, az, z
    inb = mask & np.all((idx >= 0) & (idx < np.asarray(canvas[::-1])), -1)
    coords = np.ascontiguousarray(
        idx[..., ::-1].transpose(0, 2, 1))                 # (B, 3, P) z, az, r
    return (stem_out, torch.from_numpy(coords).to(dev),
            torch.from_numpy(inb).to(dev), canvas)


def scatter_backward_case(gen, sargs):
    """The scatter-max's gradient at the flagship shape: through
    ``ScatterMaxFold2d`` on the kernel's forward, and through the same
    backward on the twin's forward, with one seeded bf16 cotangent. The
    stem's bf16 post-ReLU rows tie within their cells (zeros most of all).
    The two gradients must be bit-equal; returns the fwd+bwd ms of each
    (the kernel's through autograd) and of the backward alone, per call
    and on the device (:func:`call_and_device_ms`), and the backward's
    bound."""
    from partner_tpu_torch.ops import scatter_max

    x, coords, mask, shape = sargs
    x = x.detach().requires_grad_()
    canvas = scatter_max.scatter_max_fold2d_plain(x.detach(), coords, mask,
                                                  shape)
    g = torch.randn(canvas.shape, generator=gen).to(canvas)

    def kernel_route():
        x.grad = None
        scatter_max.ScatterMaxFold2d.apply(x, coords, mask, shape).backward(g)
        return x.grad

    def plain_route():
        with torch.no_grad():
            out = scatter_max.scatter_max_fold2d_plain(x, coords, mask,
                                                       shape)
            return scatter_max.scatter_max_fold2d_backward(
                x, coords, mask, out, g, shape)

    got, want = kernel_route().clone(), plain_route()
    torch.cuda.synchronize()
    # winners of positive cells beyond one per cell are ties
    won_pos = int(((want != 0) & (x.detach() > 0)).sum())
    log(f"scatter_max backward: {int((want != 0).sum())} row values take a "
        f"cotangent; {won_pos} positive winners for "
        f"{int((canvas > 0).sum())} positive canvas values (the excess "
        "tied); the tied zeros take it too")
    if not torch.equal(got, want):
        raise AssertionError("scatter_max backward: kernel route and twin "
                             f"route differ in {int((got != want).sum())} "
                             "elements")
    log("scatter_max backward (1, 64, 216000): bit-equal to the twin route")
    bwd = lambda: scatter_max.scatter_max_fold2d_backward(
        x.detach(), coords, mask, canvas, g, shape)
    return dict(**call_and_device_ms("fwd_bwd_ms", kernel_route),
                **call_and_device_ms("plain_fwd_bwd_ms", plain_route),
                **call_and_device_ms("bwd_ms", bwd),
                bwd_bound_ms=bound(kernel_work(
                    "scatter_max_backward", x, coords, mask, shape))[0])


def scatter_library_call(x_t, coords_t, mask, canvas_shape):
    """The one PyTorch call that computes the scatter-max, on a canvas and
    indices made beforehand: ``Tensor.scatter_reduce_(1, idx, src,
    "amax", include_self=True)``, as the plain twin makes it."""
    from partner_tpu_torch.ops import scatter_max

    b, c, _ = x_t.shape
    cells = int(np.prod(canvas_shape))
    lin = scatter_max._cell_index(coords_t, mask, canvas_shape)
    idx = lin[..., None].expand(-1, -1, c)
    src = x_t.transpose(1, 2)
    base = torch.zeros((b, cells + 1, c), dtype=x_t.dtype, device=x_t.device)
    return lambda: base.scatter_reduce_(1, idx, src, "amax",
                                        include_self=True)


def attention_library_call(args):
    """``F.scaled_dot_product_attention`` on the kernel's q, k, v with the
    RPE bias and region mask summed beforehand into one bf16 table: a
    yardstick of the attention core only (no cosine norms, no RPE MLP)."""
    import torch.nn.functional as F

    q, k, v, pos, mask, w1, b1, w2, b2, tau = args
    rel = pos[:, :, None, :] - pos[:, None, :, :]
    rpe = (torch.relu(rel @ w1 + b1) @ w2 + b2).permute(0, 3, 1, 2)
    if mask is not None:
        nm = mask.shape[0]
        rpe = (rpe.reshape(-1, nm, *rpe.shape[1:]) + mask[None, :, None]
               ).reshape(rpe.shape)
    table = rpe.to(q.dtype).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=table,
                                                  scale=1.0)


def timed(name, args, kernel, plain, library=None, label=None):
    """Times of the kernel, its plain twin and the library call, per call
    (``ms``, ``plain_ms``, ``library_ms``) and on the device
    (``device_ms``, ...; :func:`call_and_device_ms`), the kernel's bound
    and the share of the bound its device time reaches."""
    bound_ms, bound_by = bound(kernel_work(name, *args))
    r = dict(**call_and_device_ms("ms", kernel),
             **call_and_device_ms("plain_ms", plain),
             **(dict(library_ms=None, library_device_ms=None)
                if library is None else
                call_and_device_ms("library_ms", library)),
             bound_ms=bound_ms, bound_by=bound_by)
    r["bound_share"] = bound_ms / r["device_ms"]
    log(f"{label or name}: kernel {r['ms']!r} ms a call ({r['device_ms']!r} "
        "device), "
        f"plain {r['plain_ms']!r} ({r['plain_device_ms']!r}), library "
        f"{r['library_ms']!r} ({r['library_device_ms']!r}); bound "
        f"{bound_ms!r} ms by {bound_by}, {r['bound_share']!r} of it reached")
    return r


def kernel_phase(gen, dev, card):
    from partner_tpu_torch.ops import scatter_max, stem, swin_attn, swin_block

    results = {}
    args = stem_case(gen, dev)
    out = stem.stem2_channel_major(*args)
    ref = stem.stem2_channel_major_plain(*args)
    torch.cuda.synchronize()
    err = compare("stem2_channel_major (1, 10, 216000)", out, ref, KERNEL_TOL)
    results["stem"] = dict(max_abs_err=err, **not_equal("stem", out, ref),
                           **timed("stem", args,
                                   lambda: stem.stem2_channel_major(*args),
                                   lambda: stem.stem2_channel_major_plain(
                                       *args)))
    # the two-sweep CenterPoint width: C_in 11 over a 432,000-row buffer
    args = stem_case(gen, dev, cin=11, n_points=2 * N_POINTS)
    out11 = stem.stem2_channel_major(*args)
    ref11 = stem.stem2_channel_major_plain(*args)
    torch.cuda.synchronize()
    err11 = compare("stem2_channel_major (1, 11, 432000)", out11, ref11,
                    KERNEL_TOL)
    r11 = dict(**not_equal("stem C_in 11", out11, ref11),
               **timed("stem", args, lambda: stem.stem2_channel_major(*args),
                       lambda: stem.stem2_channel_major_plain(*args),
                       label=f"stem C_in 11 (1, 11, 432000) on {card}"))
    results["stem"]["max_abs_err"] = max(err, err11)
    results["stem"].update({f"{k}_cin11": v for k, v in r11.items()
                            if not k.startswith("library")})

    sargs = scatter_case(ref, dev)
    out = scatter_max.scatter_max_fold2d(*sargs)
    ref = scatter_max.scatter_max_fold2d_plain(*sargs)
    torch.cuda.synchronize()
    log(f"scatter_max: {int(sargs[2].sum())} of {sargs[2].shape[1]} rows in "
        f"the canvas {sargs[3]}, {float((ref > 0).float().mean())!r} of the "
        "canvas values > 0")
    err = compare("scatter_max_fold2d (1, 64, 216000) -> (1, 512, 288, 320)",
                  out, ref, 0.0)
    results["scatter_max"] = timed(
        "scatter_max", sargs, lambda: scatter_max.scatter_max_fold2d(*sargs),
        lambda: scatter_max.scatter_max_fold2d_plain(*sargs),
        scatter_library_call(*sargs))
    # the float32 entry (the float32 configuration), same rows
    fargs = (sargs[0].float(),) + tuple(sargs[1:])
    out = scatter_max.scatter_max_fold2d(*fargs)
    ref = scatter_max.scatter_max_fold2d_plain(*fargs)
    torch.cuda.synchronize()
    err = max(err, compare("scatter_max_fold2d float32 (1, 64, 216000)", out,
                           ref, 0.0))
    results["scatter_max"].update(
        max_abs_err=err,
        **call_and_device_ms(
            "ms_f32", lambda: scatter_max.scatter_max_fold2d(*fargs)),
        **call_and_device_ms(
            "plain_ms_f32",
            lambda: scatter_max.scatter_max_fold2d_plain(*fargs)))
    results["scatter_max"].update(scatter_backward_case(gen, sargs))
    # the two-sweep CenterPoint frame's rows: the C_in 11 stem's (1, 64,
    # 432,000) output into the same canvas
    sargs2 = scatter_case(ref11, dev, n_points=2 * N_POINTS)
    out = scatter_max.scatter_max_fold2d(*sargs2)
    ref = scatter_max.scatter_max_fold2d_plain(*sargs2)
    torch.cuda.synchronize()
    log(f"scatter_max: {int(sargs2[2].sum())} of {sargs2[2].shape[1]} rows "
        f"in the canvas {sargs2[3]}, {-(-sargs2[2].shape[1] // 128)} tiles "
        "of 128 rows")
    err2 = compare("scatter_max_fold2d (1, 64, 432000) -> (1, 512, 288, 320)",
                   out, ref, 0.0)
    r2 = dict(**not_equal("scatter_max 432000 rows", out, ref),
              **timed("scatter_max", sargs2,
                      lambda: scatter_max.scatter_max_fold2d(*sargs2),
                      lambda: scatter_max.scatter_max_fold2d_plain(*sargs2),
                      scatter_library_call(*sargs2),
                      label=f"scatter_max (1, 64, 432000) on {card}"))
    results["scatter_max"]["max_abs_err"] = max(err, err2)
    results["scatter_max"].update({f"{k}_p432000": v for k, v in r2.items()})
    del sargs2, out, ref, out11, ref11
    # a train step's batch (the frozen two-stage step runs both kernels
    # there): the stem at (4, 10, 180,000), tiles of all four samples in
    # one persistent launch, and the scatter-max of its output; drawn from
    # a generator of their own, so the cases after them keep their draws
    args4 = stem_case(torch.Generator().manual_seed(SEED + 16), dev,
                      n_points=TRAIN_POINTS, batch=4)
    shape4 = tuple(args4[0].shape)
    out4 = stem.stem2_channel_major(*args4)
    ref4 = stem.stem2_channel_major_plain(*args4)
    torch.cuda.synchronize()
    err4 = compare(f"stem2_channel_major {shape4}", out4, ref4, KERNEL_TOL)
    r4 = dict(**not_equal("stem batch 4", out4, ref4),
              **timed("stem", args4, lambda: stem.stem2_channel_major(*args4),
                      lambda: stem.stem2_channel_major_plain(*args4),
                      label=f"stem batch 4 {shape4} on {card}"))
    results["stem"]["max_abs_err"] = max(results["stem"]["max_abs_err"],
                                         err4)
    results["stem"].update({f"{k}_b4": v for k, v in r4.items()
                            if not k.startswith("library")})
    sargs4 = scatter_case(ref4, dev, n_points=TRAIN_POINTS)
    out = scatter_max.scatter_max_fold2d(*sargs4)
    ref = scatter_max.scatter_max_fold2d_plain(*sargs4)
    torch.cuda.synchronize()
    log(f"scatter_max batch 4: {sargs4[2].sum(1).tolist()} of "
        f"{sargs4[2].shape[1]} rows a sample in the canvas {sargs4[3]}")
    err4 = compare(f"scatter_max_fold2d {tuple(ref4.shape)} -> (4, 512, "
                   "288, 320)", out, ref, 0.0)
    r4 = dict(**not_equal("scatter_max batch 4", out, ref),
              **timed("scatter_max", sargs4,
                      lambda: scatter_max.scatter_max_fold2d(*sargs4),
                      lambda: scatter_max.scatter_max_fold2d_plain(*sargs4),
                      scatter_library_call(*sargs4),
                      label=f"scatter_max batch 4 {tuple(ref4.shape)} on "
                            f"{card}"))
    results["scatter_max"]["max_abs_err"] = max(
        results["scatter_max"]["max_abs_err"], err4)
    results["scatter_max"].update({f"{k}_b4": v for k, v in r4.items()})
    del args4, out4, ref4, sargs4, out, ref
    # the wrapper's zero fill of the canvas alone, in each dtype
    b, c, _ = sargs[0].shape
    for tag, dt in (("", torch.bfloat16), ("_f32", torch.float32)):
        results["scatter_max"].update(call_and_device_ms(
            f"zero_ms{tag}", lambda: torch.zeros(
                (b, int(np.prod(sargs[3])), c), dtype=dt, device=dev)))

    # the voxel path's shapes: the stem over the voxel rows (capacity
    # max_voxel_num) at C_in 10 and 11, the scatter-max of their pooled
    # coords (up to 128 full-resolution voxels a canvas cell)
    for cin, n_pts, tag in ((10, N_POINTS, "voxel"),
                            (11, 2 * N_POINTS, "voxel_cin11")):
        vargs, pooled, canvas, found = voxel_case(gen, dev, cin, n_pts)
        vout = stem.stem2_channel_major(*vargs)
        vref = stem.stem2_channel_major_plain(*vargs)
        torch.cuda.synchronize()
        shape = tuple(vargs[0].shape)
        verr = compare_stem(f"stem2_channel_major voxel path {shape}, "
                            f"{found} voxels", vout, vref, vargs)
        r = dict(voxels=found, max_abs_err=verr,
                 **not_equal(f"stem {tag}", vout, vref),
                 **timed("stem", vargs,
                         lambda: stem.stem2_channel_major(*vargs),
                         lambda: stem.stem2_channel_major_plain(*vargs),
                         label=f"stem voxel path {shape} on {card}"))
        results["stem"]["max_abs_err"] = max(results["stem"]["max_abs_err"],
                                             verr)
        results["stem"].update({f"{k}_{tag}": x for k, x in r.items()
                                if not k.startswith("library")})
        if cin == 11:
            continue
        vs_args = (vref, pooled, vargs[1], canvas)
        out = scatter_max.scatter_max_fold2d(*vs_args)
        ref = scatter_max.scatter_max_fold2d_plain(*vs_args)
        torch.cuda.synchronize()
        lin = scatter_max._cell_index(pooled, vargs[1], canvas)[vargs[1]]
        per_cell = torch.bincount(lin).max()
        log(f"scatter_max voxel path: {found} voxels in "
            f"{int(torch.unique(lin).numel())} canvas cells, at most "
            f"{int(per_cell)} a cell")
        serr = compare(f"scatter_max_fold2d voxel path (1, 64, {found}) -> "
                       f"(1, 512, 288, 320)", out, ref, 0.0)
        r = dict(max_cell_voxels=int(per_cell),
                 **not_equal("scatter_max voxel path", out, ref),
                 **timed("scatter_max", vs_args,
                         lambda: scatter_max.scatter_max_fold2d(*vs_args),
                         lambda: scatter_max.scatter_max_fold2d_plain(
                             *vs_args),
                         scatter_library_call(*vs_args),
                         label=f"scatter_max voxel path on {card}"))
        results["scatter_max"]["max_abs_err"] = max(
            results["scatter_max"]["max_abs_err"], serr)
        results["scatter_max"].update({f"{k}_voxel": x for k, x in r.items()})
        del vs_args, out, ref
    del vargs, vout, vref

    errs, times = [], {}
    for with_mask in (True, False):
        args = attn_case(gen, dev, with_mask)
        out = swin_attn.swin_vote_attention(*args)
        ref = swin_attn.swin_vote_attention_plain(*args)
        torch.cuda.synchronize()
        tag = "mask" if with_mask else "no_mask"
        errs.append(compare(f"swin_vote_attention (576, 4, 64, 64) {tag}",
                            out, ref, KERNEL_TOL))
        times[tag] = timed(
            "swin_attn", args, lambda: swin_attn.swin_vote_attention(*args),
            lambda: swin_attn.swin_vote_attention_plain(*args),
            attention_library_call(args))
    results["swin_attn"] = dict(
        max_abs_err=max(errs), **times["mask"],
        **{f"{k}_no_mask": times["no_mask"][k] for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
            "library_device_ms")})

    errs, times = [], {}
    for shift in (4, 0):
        args, (pos, mask, params) = block_case(gen, dev, shift)
        out = swin_block.swin_vote_block(*args)
        ref = swin_block.swin_vote_block_plain(*args)
        torch.cuda.synchronize()
        tag = "shifted" if shift else "unshifted"
        errs.append(compare(f"swin_vote_block (1, 256, 144, 256) {tag}",
                            out, ref, KERNEL_TOL))
        times[tag] = timed(
            "swin_block", args, lambda: swin_block.swin_vote_block(*args),
            lambda: swin_block.swin_vote_block_plain(*args))
        times[tag].update(call_and_device_ms(
            "bias_table_ms", lambda: swin_block.block_bias_table(
                pos, mask, params["rpe"], torch.bfloat16, args[-1])))
    results["swin_block"] = dict(
        max_abs_err=max(errs), **times["shifted"],
        **{f"{k}_unshifted": times["unshifted"][k] for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms")},
        more_draws=block_draws(dev, card))

    sm = results["scatter_max"]
    log(f"scatter_max float32: kernel {sm['ms_f32']!r} ms a call "
        f"({sm['device_ms_f32']!r} device), plain {sm['plain_ms_f32']!r} "
        f"({sm['plain_device_ms_f32']!r})")
    log(f"scatter_max canvas fill alone (torch.zeros): {sm['zero_ms']!r} ms "
        f"a call ({sm['zero_device_ms']!r} device); float32 "
        f"{sm['zero_ms_f32']!r} ({sm['zero_device_ms_f32']!r})")
    log(f"scatter_max fwd+bwd: kernel route {sm['fwd_bwd_ms']!r} ms a call "
        f"({sm['fwd_bwd_device_ms']!r} device; through autograd), twin "
        f"route {sm['plain_fwd_bwd_ms']!r} ({sm['plain_fwd_bwd_device_ms']!r})"
        f"; the backward alone {sm['bwd_ms']!r} ({sm['bwd_device_ms']!r}), "
        f"its bound {sm['bwd_bound_ms']!r} ms by bytes")
    sb = results["swin_block"]
    log(f"swin_block: its bias table (plain torch, outside the kernel) "
        f"{sb['bias_table_ms']!r} ms a call ({sb['bias_table_device_ms']!r} "
        "device)")
    return results


# -------------------------------------------------------------------- frame

@torch.no_grad()
def randomize_norms(module, gen):
    """Draw every norm scale/bias, BN statistic, stem affine and tau from
    ``gen``: with fresh LayerNorms the keypoint saliency is exactly 0 and
    the keypoint choice is rounding noise."""
    from partner_tpu_torch.models.layers import BatchNorm

    def draw(t, positive):
        t.copy_(0.5 + torch.rand(t.shape, generator=gen) if positive
                else 0.2 * torch.randn(t.shape, generator=gen))

    for name, t in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        is_norm = isinstance(module.get_submodule(owner_name),
                             (torch.nn.LayerNorm, BatchNorm))
        if leaf == "tau" or leaf.endswith("_scale") or (
                is_norm and leaf == "weight"):
            draw(t, positive=True)
        elif leaf.endswith("_bias") or (is_norm and leaf == "bias"):
            draw(t, positive=False)
    for name, t in module.named_buffers():
        draw(t, positive=name.endswith("var"))


def synthetic_sweep(rng, pc_range, n_points, c=7):
    """bench.py's "realistic" sweep: log-uniform range (p(rho) ~ 1/rho),
    ground-hugging z, uniform azimuth; padded to 1.2x rows."""
    rho = np.exp(rng.uniform(np.log(pc_range[0] + 0.2),
                             np.log(pc_range[3] - 0.2), n_points))
    z = pc_range[2] + np.abs(rng.randn(n_points)) * 0.18 * (
        pc_range[5] - pc_range[2])
    z = np.clip(z, pc_range[2], pc_range[5])
    phi = rng.uniform(pc_range[1], pc_range[4], n_points)
    cols = [rho, phi, z, rho * np.cos(phi), rho * np.sin(phi)]
    while len(cols) < c:
        cols.append(rng.rand(n_points))
    pad = np.zeros((1, int(n_points * 1.2), c), np.float32)
    pad[0, :n_points] = np.stack(cols[:c], 1)
    mask = np.zeros(pad.shape[:2], bool)
    mask[0, :n_points] = True
    return pad, mask


def frame_cfgs(grid=None, compute_dtype=None):
    """(model cfg, test cfg) of the flagship config, optionally on another
    grid (same widths) or with every compute dtype replaced."""
    import copy

    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    m = copy.deepcopy(cfg["model"])
    tc = copy.deepcopy(cfg["test_cfg"])
    # random weights put almost every score under 0.1; 0 sends the top
    # 2,048 candidates through the NMS
    tc["score_threshold"] = 0.0
    if grid is not None:
        vg = m["bbox_head"]["voxel_generator"]
        r = vg["range"]
        vg["voxel_size"] = [(r[3 + i] - r[i]) / grid[i] for i in range(3)]
    if compute_dtype is not None:
        m["backbone"]["compute_dtype"] = compute_dtype
        m["neck"]["compute_dtype"] = compute_dtype
        m["bbox_head"]["HEAD_CONFIG"]["compute_dtype"] = compute_dtype
    return m, tc


def to_device(example, dev):
    """numpy arrays (and per-task lists of them) -> tensors on ``dev``."""
    move = lambda a: torch.from_numpy(a).to(dev)
    return {k: [move(a) for a in v] if isinstance(v, list) else move(v)
            for k, v in example.items()}


def frame_phase(dev, card):
    """Both head routes on one flagship detector's weights, taking turns
    frame by frame: per route, the launch counts (set to 0 just before
    each of its frames, read just after), the median frame time and sane
    detections."""
    from partner_tpu_torch.models import build_detector

    m, tc = frame_cfgs()
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    dets = {"per_block": build_detector(m, None, tc, device=dev,
                                        generator=gen)}
    randomize_norms(dets["per_block"].module, gen)
    dets["whole_block"] = build_detector(m, None, tc, device=dev,
                                         use_block_kernel=True)
    dets["whole_block"].module.load_state_dict(
        dets["per_block"].module.state_dict())
    n_params = sum(p.numel() for p in dets["per_block"].module.parameters())
    log(f"flagship detector: grid {dets['per_block'].module.grid_size}, "
        f"{n_params} params, both routes built in "
        f"{time.perf_counter() - t0:.1f} s")
    pts, mask = synthetic_sweep(np.random.RandomState(SEED),
                                m["bbox_head"]["voxel_generator"]["range"],
                                N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    wrappers = kernel_wrappers()
    depth = dets["per_block"].module.bbox_head.layer.depth
    tally = {route: dict.fromkeys(wrappers, 0) for route in dets}
    times = {route: [] for route in dets}
    outs = {}
    for i in range(FRAMES + 1):  # round 0 warms up; the routes take turns
        for route in (list(dets) if i % 2 == 0 else list(dets)[::-1]):
            ms, outs[route], counts = counted(
                lambda: dets[route].predict(ex))
            if i:
                times[route].append(ms)
            for name in wrappers:
                tally[route][name] += counts[name]
    frames = FRAMES + 1
    results = {}
    for route, launches in tally.items():
        median = statistics.median(times[route])
        log(f"flagship frame, {route} route: median {median!r} ms over "
            f"{FRAMES} frames on {card} (host clock around a synchronized "
            f"predict, routes interleaved), all {times[route]!r}")
        log(f"{route} kernel launches over {frames} frames: {launches}")
        attn_n = depth * frames if route == "per_block" else 0
        want = {"stem": frames, "scatter_max": frames, "swin_attn": attn_n,
                "swin_block": depth * frames - attn_n}
        if launches != want:
            raise AssertionError(f"{route}: launches {launches} != {want}")
        check_detections(outs[route], tc)
        results[route] = (launches, median)
    return results


def check_detections(out, tc, box_dim=7):
    post = tc["nms"]["nms_post_max_size"]
    shapes = {"box3d_lidar": (1, post, box_dim), "scores": (1, post),
              "label_preds": (1, post), "mask": (1, post)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(out[k].shape)}")
    kept = out["mask"][0]
    n_kept = int(kept.sum())
    if not (torch.isfinite(out["box3d_lidar"][0][kept]).all()
            and torch.isfinite(out["scores"][0][kept]).all()):
        raise AssertionError("non-finite detections")
    log(f"NMS kept {n_kept} of {tc['nms']['nms_pre_max_size']} candidates "
        f"(post max {post})")
    if not 0 < n_kept < tc["nms"]["nms_pre_max_size"]:
        raise AssertionError(f"NMS kept {n_kept} boxes")
    return n_kept


def rel_rms_of(name, got, want):
    """(||got - want|| / ||want||, max |got - want|) on the CPU in f32."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"reference {name}: shape or non-finite")
    err = (got - want).abs()
    return float(err.norm() / want.norm()), float(err.max())


def rel_rms(name, got, want, bound):
    r, max_err = rel_rms_of(name, got, want)
    log(f"reference {name} {tuple(want.shape)}: relative RMS error {r!r} "
        f"(bound {bound}), max abs err {max_err!r}")
    if not r <= bound:
        raise AssertionError(f"reference {name}: {r} beyond {bound}")


@torch.no_grad()
def reference_phase(dev):
    """Flagship widths on SMALL_GRID, same weights and points: each stage
    on the card (bf16 with the CUDA kernels) against the CPU (float32 with
    the plain twins), fed the CPU's input to that stage."""
    from partner_tpu_torch.models import build_detector

    m, tc = frame_cfgs(grid=SMALL_GRID)
    gen = torch.Generator().manual_seed(SEED + 1)
    card = build_detector(m, None, tc, device=dev, generator=gen).module
    randomize_norms(card, gen)
    m32, _ = frame_cfgs(grid=SMALL_GRID, compute_dtype="float32")
    cpu = build_detector(m32, None, tc, device="cpu").module
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    pts, mask = synthetic_sweep(np.random.RandomState(SEED + 1),
                                m["bbox_head"]["voxel_generator"]["range"],
                                30_000)
    ex = {"points": pts, "points_mask": mask}
    exc, exg = to_device(ex, "cpu"), to_device(ex, dev)

    bev = cpu.backbone.encode_points(exc["points"], exc["points_mask"],
                                     cpu.grid_size, cpu.pc_range)
    rel_rms("backbone BEV", card.backbone.encode_points(
        exg["points"], exg["points_mask"], card.grid_size, card.pc_range),
        bev, REF_BF16)
    pos = torch.from_numpy(cpu.bev_pos)[None]
    set_out = cpu.attns(bev.transpose(1, 2), pos).transpose(1, 2)
    rel_rms("SetBlock", card.attns(bev.to(dev).transpose(1, 2),
                                   pos.to(dev)).transpose(1, 2),
            set_out, REF_F32)
    want = cpu.bbox_head(cpu.neck(set_out))
    got = card.bbox_head(card.neck(set_out.to(dev)))
    for k in sorted(want):
        rel_rms(f"RPN + head {k}", got[k], want[k], REF_BF16)
    # the whole-block route, same weights: card (block kernel, bf16) vs CPU
    # (the block op's twin, float32)
    cpu_b, card_b = (
        build_detector(cfg, None, tc, device=d,
                       use_block_kernel=True).module
        for cfg, d in ((m32, "cpu"), (m, dev)))
    cpu_b.load_state_dict(cpu.state_dict())
    card_b.load_state_dict(card.state_dict())
    want = cpu_b.bbox_head(cpu_b.neck(set_out))
    got = card_b.bbox_head(card_b.neck(set_out.to(dev)))
    for k in sorted(want):
        rel_rms(f"RPN + head {k}, whole-block route", got[k], want[k],
                REF_BF16)


# -------------------------------------------------------------------- train

def synthetic_scene(rng, pc_range, n_points, max_boxes):
    """One synthetic sweep: ``max_boxes // 2`` to ``max_boxes`` vehicle
    boxes [x, y, z, dx, dy, dz, yaw], half the points on them and half in
    the background -> (boxes (nb, 7), cartesian xyz (n_points, 3))."""
    nb = rng.randint(max_boxes // 2, max_boxes + 1)
    rho = rng.uniform(pc_range[0] + 5, pc_range[3] * 0.8, nb)
    phi = rng.uniform(pc_range[1] * 0.9, pc_range[4] * 0.9, nb)
    boxes = np.stack([rho * np.cos(phi), rho * np.sin(phi),
                      rng.uniform(-0.5, 0.5, nb), rng.uniform(3.5, 5.5, nb),
                      rng.uniform(1.6, 2.2, nb), rng.uniform(1.4, 2.0, nb),
                      rng.uniform(-np.pi, np.pi, nb)], 1)
    per_box = n_points // (2 * nb)
    on = [rng.uniform(-0.5, 0.5, (per_box, 3)) * bx[3:6] + bx[:3]
          for bx in boxes]
    n_bg = n_points - per_box * nb
    bg_r = rng.uniform(pc_range[0] + 0.5, pc_range[3] - 0.5, n_bg)
    bg_t = rng.uniform(pc_range[1], pc_range[4], n_bg)
    bg = np.stack([bg_r * np.cos(bg_t), bg_r * np.sin(bg_t),
                   rng.uniform(pc_range[2], pc_range[5], n_bg)], 1)
    return boxes, np.concatenate(on + [bg])


def train_example(rng, pc_range, grid, batch, n_points, rows, max_boxes):
    """bench.py's synthetic train batch, made with numpy and the port's
    ``core.targets`` (``partner_tpu.testing.make_flagship_example`` without
    the JAX package): per sample a :func:`synthetic_scene` in the cylinder
    layout [rho, phi, z, x, y, intensity, extra], padded to ``rows``;
    ``global_box`` [x, y, z, dx, dy, dz, yaw, class 1], its mask, and the
    flattened vote maps."""
    from partner_tpu_torch.core.targets import draw_votemap

    vs = [(pc_range[3 + i] - pc_range[i]) / grid[i] for i in range(3)]
    gt = np.zeros((batch, max_boxes, 8), np.float32)
    pts = np.zeros((batch, rows, 7), np.float32)
    mask = np.zeros((batch, rows), bool)
    votemaps = []
    for i in range(batch):
        boxes, xyz = synthetic_scene(rng, pc_range, n_points, max_boxes)
        nb = len(boxes)
        r, a = np.hypot(xyz[:, 0], xyz[:, 1]), np.arctan2(xyz[:, 1], xyz[:, 0])
        pts[i, :n_points] = np.stack(
            [r, a, xyz[:, 2], xyz[:, 0], xyz[:, 1], rng.rand(n_points),
             rng.rand(n_points)], 1)
        mask[i, :n_points] = True
        gt[i, :nb, :7] = boxes
        gt[i, :nb, 7] = 1
        votemaps.append(draw_votemap(boxes.astype(np.float32), np.zeros(nb),
                                     1, grid, vs, pc_range, 8))
    vm = np.stack(votemaps)
    return {"points": pts, "points_mask": mask, "global_box": gt,
            "global_box_mask": gt[..., 7] > 0,
            "votemap_flat": vm.reshape(batch, -1, vm.shape[-1])}


def centerpoint_train_example(rng, model_cfg, train_cfg, batch, n_points,
                              rows, max_boxes):
    """A CenterPoint train batch made with numpy and the port's
    ``CenterTargetAssigner`` (what ``AssignLabel`` gives the CLI): per
    sample a :func:`synthetic_scene` whose boxes take the config's classes
    in turn and a random velocity, in the cylinder layout [rho, phi, z, x,
    y, then uniform extras up to the backbone's input features], padded to
    ``rows``; per task ``hm`` (B, az, r, C), ``anno_box``, ``ind``,
    ``mask`` and ``cat``; and ``global_box`` (B, max_boxes, 10) [x, y, z,
    dx, dy, dz, vx, vy, yaw, class 1-based] with its mask (the two-stage
    RoI targets)."""
    from partner_tpu_torch.core.targets import CenterTargetAssigner

    bh = model_cfg["bbox_head"]
    vg = bh["voxel_generator"]
    pc_range = vg["range"]
    grid = [int(round((pc_range[3 + i] - pc_range[i]) / vg["voxel_size"][i]))
            for i in range(3)]
    a = train_cfg["assigner"]
    assigner = CenterTargetAssigner(
        bh["tasks"], a["out_size_factor"], a["gaussian_overlap"],
        a["max_objs"], a["min_radius"], a["voxel_shape"])
    n_cls = sum(len(t["class_names"]) for t in bh["tasks"])
    c = model_cfg["backbone"]["num_input_features"]
    pts = np.zeros((batch, rows, c), np.float32)
    mask = np.zeros((batch, rows), bool)
    global_box = np.zeros((batch, max_boxes, 10), np.float32)
    targets = []
    for i in range(batch):
        boxes, xyz = synthetic_scene(rng, pc_range, n_points, max_boxes)
        r, ph = np.hypot(xyz[:, 0], xyz[:, 1]), np.arctan2(xyz[:, 1],
                                                          xyz[:, 0])
        cols = [r, ph, xyz[:, 2], xyz[:, 0], xyz[:, 1]]
        cols += [rng.rand(n_points) for _ in range(c - len(cols))]
        pts[i, :n_points] = np.stack(cols, 1)
        mask[i, :n_points] = True
        gt = np.concatenate([boxes[:, :6], rng.randn(len(boxes), 2),
                             boxes[:, 6:]], 1).astype(np.float32)
        classes = np.arange(len(boxes)) % n_cls + 1
        targets.append(assigner.assign(gt, classes, grid, vg["voxel_size"],
                                       pc_range))
        global_box[i, :len(gt), :9] = gt
        global_box[i, :len(gt), 9] = classes
    ex = {"points": pts, "points_mask": mask, "global_box": global_box,
          "global_box_mask": global_box[..., -1] > 0}
    for k in ("hm", "anno_box", "ind", "mask", "cat"):
        ex[k] = [np.stack([t[k][j] for t in targets])
                 for j in range(len(bh["tasks"]))]
    ex["hm"] = [h.transpose(0, 2, 3, 1) for h in ex["hm"]]   # NHWC
    return ex


def train_cfgs(grid=None, compute_dtype=None):
    """(model cfg, test cfg, samples per card, lr_max) of the flagship."""
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    m, tc = frame_cfgs(grid, compute_dtype)
    return m, tc, cfg["data"]["samples_per_gpu"], cfg["lr_config"]["lr_max"]


def kernel_wrappers():
    from partner_tpu_torch.ops import scatter_max, stem, swin_attn, swin_block

    return {"stem": stem.stem2_channel_major,
            "scatter_max": scatter_max.scatter_max_fold2d,
            "swin_attn": swin_attn.swin_vote_attention,
            "swin_block": swin_block.swin_vote_block}


def counted(fn):
    """``fn()`` with every kernel wrapper's launch count set to 0 just
    before it and read just after, the card synchronized -> (host ms,
    its result, {kernel: launches})."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, out, {name: w.launches for name, w in wrappers.items()}


def timed_train_steps(det, step, ex, drops, want, label):
    """One warm-up and TRAIN_STEPS timed calls of ``step(ex, drops)``,
    each :func:`counted` and launching ``want``, with finite metrics (each
    task's too) and a gradient norm > 0; after them every parameter's
    gradient present and finite, and every parameter and BatchNorm
    statistic of ``det`` moved. -> (launches summed over every step,
    median host ms of the timed steps, all their ms, each step's metrics
    as floats, peak memory in GiB since the caller's reset)."""
    before = {k: v.detach().clone() for k, v in det.module.state_dict().items()}
    times, launches, steps = [], dict.fromkeys(want, 0), []
    for i in range(TRAIN_STEPS + 1):   # step 0 warms up
        ms, met, counts = counted(lambda: step(ex, drops))
        if counts != want:
            raise AssertionError(f"{label} {i}: launches {counts} != {want}")
        if i:
            times.append(ms)
        for name in launches:
            launches[name] += counts[name]
        vals = {k: [float(x) for x in v] if isinstance(v, list) else float(v)
                for k, v in met.items()}
        log(f"{label} {i}: {ms!r} ms, " + ", ".join(
            f"{k} {v!r}" for k, v in sorted(vals.items())))
        flat = [x for v in vals.values()
                for x in (v if isinstance(v, list) else [v])]
        if not all(np.isfinite(flat)):
            raise AssertionError(f"{label} {i}: non-finite metrics")
        if not vals["grad_norm"] > 0:
            raise AssertionError(f"{label} {i}: no gradient")
        steps.append(vals)
    for name, p in det.module.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{label}: gradient of {name} missing or "
                                 "non-finite")
    after = det.module.state_dict()
    watched = [k for k, _ in det.module.named_parameters()] + [
        k for k in before if k.endswith(("_mean", "_var"))]
    still = [k for k in watched if torch.equal(before[k], after[k])]
    if still:
        raise AssertionError(f"{label}: unchanged after the steps: "
                             f"{still[:5]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return launches, statistics.median(times), times, steps, peak


def train_phase(dev, card):
    """The flagship train step at full width and the config's batch:
    launch counts per step, step times, peak memory, finite losses and
    gradients, and parameters and BatchNorm statistics that moved
    (:func:`timed_train_steps`), and a match in every step."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    m, tc, batch, lr_max = train_cfgs()
    gen = torch.Generator().manual_seed(SEED + 3)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    grid = det.module.grid_size
    ex = to_device(train_example(
        np.random.RandomState(SEED + 3), m["bbox_head"]["voxel_generator"][
            "range"], grid, batch, TRAIN_POINTS, TRAIN_ROWS, MAX_BOXES), dev)
    log(f"train batch: {batch} samples of {TRAIN_POINTS} points in "
        f"{TRAIN_ROWS} rows, {ex['global_box_mask'].sum(1).tolist()} boxes")
    step = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max=lr_max, total_steps=1000))
    drops = torch.Generator().manual_seed(SEED + 3)  # dropout and DropPath
    want = {"stem": 0, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    launches, median, times, steps, peak = timed_train_steps(
        det, step, ex, drops, want, "train step")
    if not all(v["num_matched"] > 0 for v in steps):
        raise AssertionError("train: a step with no match")
    log(f"flagship train step, batch {batch}: median {median!r} ms over "
        f"{TRAIN_STEPS} steps on {card} (host clock around a synchronized "
        f"step), all {times!r}; peak memory {peak!r} GiB "
        "(torch.cuda.max_memory_allocated, weights and Adam state included)")
    log(f"train kernel launches over {TRAIN_STEPS + 1} steps: {launches}")
    return launches, median, peak


def one_train_step(m, tc, dev, state, ex, lr_max):
    """One ``make_train_step`` step of a detector built from ``m`` on
    ``dev`` with the weights ``state``; -> (metrics, matched query per gt,
    gradients by parameter name), all on the CPU in float32."""
    from partner_tpu_torch.losses import set_crit
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    det = build_detector(m, None, tc, device=dev)
    det.module.load_state_dict(state)
    seen = []
    assign = set_crit.assign_auction

    def recorded(*args, **kwargs):
        seen.append(assign(*args, **kwargs))
        return seen[-1]

    set_crit.assign_auction = recorded
    try:
        met = make_train_step(det, build_one_cycle_optimizer(
            det.module, lr_max=lr_max, total_steps=1000))(
                to_device(ex, dev), torch.Generator().manual_seed(SEED + 4))
    finally:
        set_crit.assign_auction = assign
    grads = {k: p.grad.float().cpu() for k, p in det.module.named_parameters()}
    return ({k: float(v) for k, v in met.items()}, seen[0].cpu(), grads)


def grad_errors(got, want):
    """Per top-level module: (||grad got - grad want|| / ||grad want||,
    ||grad got|| / ||grad want||)."""
    res = {}
    for top in ("backbone", "attns", "neck", "bbox_head"):
        names = [k for k in want if k.startswith(top + ".")]
        g = torch.cat([got[k].flatten() for k in names])
        w = torch.cat([want[k].flatten() for k in names])
        res[top] = (float((g - w).norm() / w.norm()), float(g.norm() / w.norm()))
    return res


def train_reference(card_dev, seed=SEED + 4):
    """One train step on SMALL_GRID at full width, batch 2, with the same
    weights, example and dropout draws: the card in the config's bf16 and
    the card in float32, each against the CPU in float32. -> {"bf16": ...,
    "float32": ...}, each a dict of the relative error of each loss term,
    per top-level module the relative RMS error of the gradients and the
    ratio of their norms, the matches that differ and num_matched of each
    side."""
    from partner_tpu_torch.models import build_detector

    m, tc, _, lr_max = train_cfgs(SMALL_GRID)
    m32, _, _, _ = train_cfgs(SMALL_GRID, "float32")
    gen = torch.Generator().manual_seed(seed)
    init = build_detector(m32, None, tc, device="cpu", generator=gen).module
    randomize_norms(init, gen)
    state = init.state_dict()
    ex = train_example(np.random.RandomState(seed),
                       m["bbox_head"]["voxel_generator"]["range"],
                       SMALL_GRID, 2, 30_000, 36_000, 16)
    want = one_train_step(m32, tc, "cpu", state, ex, lr_max)
    out = {}
    for tag, cfg in (("bf16", m), ("float32", m32)):
        got = one_train_step(cfg, tc, card_dev, state, ex, lr_max)
        out[tag] = {
            "loss": {k: abs(got[0][k] - want[0][k]) / abs(want[0][k])
                     for k in want[0] if k.startswith("loss")},
            "grad": grad_errors(got[2], want[2]),
            "flips": int((got[1] != want[1]).sum()),
            "matched": (got[0]["num_matched"], want[0]["num_matched"])}
    return out


def train_reference_phase(dev):
    bad = {}
    for tag, res in train_reference(dev).items():
        matched = res["matched"]
        log(f"train reference, card {tag}: num_matched card {matched[0]!r}, "
            f"cpu {matched[1]!r}; {res['flips']} matches differ")
        if matched[0] != matched[1]:
            bad[f"{tag} num_matched"] = matched
        for k, e in sorted(res["loss"].items()):
            bound = (TRAIN_LOSS_TOL.get(k, TRAIN_TERM_TOL) if tag == "bf16"
                     else TRAIN_F32_LOSS_TOL)
            log(f"train reference, card {tag}, {k}: relative error {e!r} "
                f"(bound {bound})")
            if not e <= bound:
                bad[f"{tag} {k}"] = e
        for k, (e, r) in res["grad"].items():
            bound = (TRAIN_GRAD_TOL if tag == "bf16" else TRAIN_F32_GRAD_TOL
                     ).get(k)
            log(f"train reference, card {tag}, grad {k}: relative RMS error "
                f"{e!r} (bound {bound or 'none: uncorrelated in bf16'}), "
                f"norm ratio card / cpu {r!r} (bound {TRAIN_NORM_TOL})")
            if bound is not None and not e <= bound:
                bad[f"{tag} grad {k}"] = e
            if not abs(np.log(r)) <= np.log(TRAIN_NORM_TOL):
                bad[f"{tag} grad norm {k}"] = r
    if bad:
        raise AssertionError(f"train reference beyond its bounds: {bad}")


# --------------------------------------------------------- eval, static RPE

def write_val_set(root, rng, pc_range, n_frames, names=("Vehicle",)):
    """A synthetic Waymo val info pkl under ``root``: per frame a
    :func:`synthetic_scene` of N_POINTS points as raw [x, y, z, intensity,
    elongation] rows (the pipeline's ``transform_points`` adds rho, phi),
    its boxes as gts [x, y, z, dx, dy, dz, vx, vy, yaw] named by
    ``names`` in turn (vehicles only by default)."""
    import pickle

    infos = []
    for i in range(n_frames):
        boxes, xyz = synthetic_scene(rng, pc_range, N_POINTS, MAX_BOXES)
        gt = np.zeros((len(boxes), 9), np.float32)
        gt[:, :6], gt[:, 8] = boxes[:, :6], boxes[:, 6]
        pts = np.concatenate([xyz, rng.rand(len(xyz), 2)], 1)
        infos.append({"token": f"frame_{i}", "points": pts.astype(np.float32),
                      "gt_boxes": gt, "gt_names": np.array(
                          [names[j % len(names)] for j in range(len(gt))])})
    path = os.path.join(root, "infos_val.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


def write_eval_config(root, info_path):
    """The flagship config file with ``score_threshold`` 0 (as
    :func:`frame_cfgs`) and ``data.val`` at ``info_path``."""
    path = os.path.join(root, "eval_cfg.py")
    with open(path, "w") as f:
        f.write(f"exec(open({CONFIG!r}).read())\n"
                "test_cfg['score_threshold'] = 0.0\n"
                f"data['val'].update(info_path={info_path!r}, "
                f"root_path={root!r})\n")
    return path


def sample_clocks(fn):
    """Runs ``fn()`` while ``nvidia-smi -lms 100`` samples card 0's SM clock
    and power draw into a file -> (fn's result, [(unix seconds, SM MHz,
    W)]); an empty list where nvidia-smi gave no sample."""
    import datetime
    import tempfile

    with tempfile.TemporaryFile("w+") as f:
        proc = subprocess.Popen(
            ["nvidia-smi", "--id=0", "--query-gpu=timestamp,clocks.sm,"
             "power.draw", "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=f, stderr=subprocess.DEVNULL)
        try:
            time.sleep(0.3)
            result = fn()
            time.sleep(0.3)
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        f.seek(0)
        lines = f.read().splitlines()
    samples = []
    for line in lines:
        try:
            ts, mhz, watts = (x.strip() for x in line.split(","))
            t = datetime.datetime.strptime(ts, "%Y/%m/%d %H:%M:%S.%f")
            samples.append((t.timestamp(), float(mhz), float(watts)))
        except ValueError:
            continue
    return result, samples


def eval_phase(dev, card):
    """The flagship detector's seeded random weights saved as a port
    checkpoint, then ``partner_tpu_torch.tools.dist_test.main`` over a
    synthetic val set of EVAL_FRAMES sweeps on the card: the launch counts
    over the run, each frame's kept boxes against a direct ``predict`` of
    the same collated batch (bit-equal), the metric keys, the middle-third
    FPS, the host time per frame beyond ``predict``, ``predict``'s time in
    dist_test against the direct detector's on batches collated first, and
    the card's SM clock and power over each third of the frames."""
    import pickle
    import tempfile

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.models.detectors import E2EDetector
    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.utils.config import load_config

    m, tc = frame_cfgs()
    gen = torch.Generator().manual_seed(SEED + 5)
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    depth = det.module.bbox_head.layer.depth
    predict, spans = E2EDetector.predict, []

    def timed_predict(self, example):
        t0 = time.time()
        out = predict(self, example)
        torch.cuda.synchronize()
        spans.append((t0, time.time()))
        return out

    with tempfile.TemporaryDirectory() as root:
        info_path = write_val_set(root, np.random.RandomState(SEED + 5),
                                  m["bbox_head"]["voxel_generator"]["range"],
                                  EVAL_FRAMES)
        cfg_path = write_eval_config(root, info_path)
        save_checkpoint(os.path.join(root, "ckpt"), 0, det.module.state_dict())
        work_dir = os.path.join(root, "eval")
        E2EDetector.predict = timed_predict
        try:
            wall_ms, (((metrics, _), fps), clocks), launches = counted(
                lambda: sample_clocks(lambda: dist_test.main([
                    cfg_path, "--checkpoint",
                    os.path.join(root, "ckpt", "latest"),
                    "--work_dir", work_dir, "--max_points", str(EVAL_ROWS),
                    "--device", torch.device(dev).type])))
            wall_s = wall_ms / 1e3
        finally:
            E2EDetector.predict = predict
        with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
            preds = pickle.load(f)
        # the same batches collated first, then predicted by the direct
        # detector (also fresh) with no loader thread running beside it
        ds = build_dataset(dict(load_config(cfg_path)["data"]["val"]))
        batches = list(DataLoader(ds, 1, shuffle=False, max_points=EVAL_ROWS))
        direct, direct_ms = {}, []
        for b in batches:
            ex = to_device({k: b[k] for k in ("points", "points_mask")}, dev)
            t0 = time.perf_counter()
            out = det.predict(ex)
            torch.cuda.synchronize()
            direct_ms.append((time.perf_counter() - t0) * 1e3)
            keep = out["mask"][0]
            direct[b["metadata"][0]["token"]] = {
                k: out[k][0][keep].cpu().numpy()
                for k in ("box3d_lidar", "scores", "label_preds")}
    want = {"stem": EVAL_FRAMES, "scatter_max": EVAL_FRAMES,
            "swin_attn": depth * EVAL_FRAMES, "swin_block": 0}
    log(f"eval kernel launches over {EVAL_FRAMES} frames: {launches}")
    if launches != want:
        raise AssertionError(f"eval: launches {launches} != {want}")
    if sorted(preds) != sorted(direct):
        raise AssertionError(f"eval: tokens {sorted(preds)}")
    n_kept = 0
    for token, d in sorted(direct.items()):
        p = preds[token]
        n_kept += len(p["scores"])
        if not all(np.array_equal(p[k], d[k]) for k in d):
            raise AssertionError(f"eval {token}: prediction.pkl differs from "
                                 "a direct predict of the same batch")
    log(f"eval: all {len(direct)} frames' {n_kept} kept boxes bit-equal to "
        "a direct predict of the same batch")
    for k in ("mAP/L1", "mAPH/L1", "mAP/L2", "mAPH/L2", "AP/L1/Vehicle"):
        if k not in metrics or not np.isfinite(metrics[k]):
            raise AssertionError(f"eval: metric {k} missing or not finite")
    log("eval metrics: " + ", ".join(
        f"{k} {metrics[k]!r}" for k in sorted(metrics) if "/[" not in k))
    predict_ms = [(b - a) * 1e3 for a, b in spans]
    third = max(1, EVAL_FRAMES // 3)
    window = predict_ms[third: 2 * third]
    beyond = 1e3 / fps - statistics.mean(window)
    log(f"eval through dist_test on {card}: middle-third FPS {fps!r} "
        f"({EVAL_FRAMES} frames of {N_POINTS} points in {EVAL_ROWS} rows, "
        f"batch 1, the window frames {third}-{2 * third - 1}); predict ms "
        f"(synchronized) {predict_ms!r}; mean predict in the window "
        f"{statistics.mean(window)!r}; host time per frame beyond predict "
        f"in the window {beyond!r} ms (host -> device copy and outputs "
        f"back); whole main {wall_s!r} s")
    quiet = statistics.mean(direct_ms[third: 2 * third])
    log(f"eval: the same frames predicted with every batch collated first "
        f"(no loader thread running): predict ms {direct_ms!r}; mean in the "
        f"window {quiet!r}, so {statistics.mean(window) - quiet!r} ms a "
        f"frame of dist_test's predict went to sharing the host with its "
        f"loader's threads; FPS without them "
        f"{1e3 / (quiet + beyond)!r}")
    thirds = {}
    for i, tag in enumerate(("first", "middle", "last")):
        lo, hi = spans[i * third][0], spans[min((i + 1) * third,
                                                EVAL_FRAMES) - 1][1]
        got = [(mhz, w) for t, mhz, w in clocks if lo <= t <= hi]
        thirds[tag] = (statistics.median([c for c, _ in got]) if got else
                       None, statistics.median([w for _, w in got]) if got
                       else None, len(got))
    idle = [mhz for t, mhz, _ in clocks if t < spans[0][0]]
    log(f"eval: nvidia-smi every 100 ms, {len(clocks)} samples; median SM "
        f"MHz and power W by third of the frames (samples): {thirds}; "
        f"before the first frame: SM MHz {idle!r}")
    return launches, fps, beyond, thirds, quiet


def device_busy(run, calls=3):
    """torch.profiler over ``calls`` calls of ``run``: (summed device time
    of the kernels, kernels) per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.device_time for e in kernels) / 1e3 / calls,
            len(kernels) / calls)


def matched_boxes(live, cached):
    """Kept boxes of a live and a cached frame: each live box's nearest
    cached box by center -> (share of live boxes with a cached box within
    STATIC_MATCH_M, relative RMS error of those pairs' boxes)."""
    a = live["box3d_lidar"][0][live["mask"][0]].float().cpu()
    b = cached["box3d_lidar"][0][cached["mask"][0]].float().cpu()
    d, j = torch.cdist(a[:, :3], b[:, :3]).min(1)
    ok = d <= STATIC_MATCH_M
    err = float((b[j[ok]] - a[ok]).norm() / a[ok].norm())
    return float(ok.float().mean()), err


def static_readings(maps, out, ref_maps, ref_out):
    """(largest relative RMS error over the head maps, share of the
    reference frame's kept boxes with a kept box of ``out`` within
    STATIC_MATCH_M, relative RMS error of those boxes)."""
    worst = max(rel_rms_of(k, maps[k], ref_maps[k])[0] for k in ref_maps)
    return (worst,) + matched_boxes(ref_out, out)


def static_verdict(plain, live):
    """The bounds a cache's readings against the live plain frame and the
    live kernel frame (:func:`static_readings`) break; [] if none."""
    broken = []
    if not plain[0] <= STATIC_PLAIN_TOL:
        broken.append("maps vs plain")
    if not plain[1] >= 1.0:
        broken.append("kept boxes vs plain")
    if not live[0] <= STATIC_MAP_TOL:
        broken.append("maps vs kernel")
    if not (live[1] >= STATIC_MATCH_SHARE and live[2] <= REF_BF16):
        broken.append("kept boxes vs kernel")
    return broken


def planted_tables(det, tables, ex, m, tc, dev):
    """Plausible wrong caches -> {fault: {attention name: table}}: the
    region mask not folded in, the windows in column-major order, the
    table filled by a detector of other weights, and the RPE in float32
    (the kernel's precision, not the plain path's)."""
    from partner_tpu_torch.models import build_detector, e2e_head, swin_vote

    attns = dict(det.module.named_modules())
    grid, pc_range, ws = flagship_grid()
    h, w = e2e_head.head_offset_grid(grid, pc_range, 8).shape[:2]
    faults = {"mask not folded": {}, "windows column-major": {}}
    for name, t in tables.items():
        shift = attns[name.rpartition(".")[0]].shift_size
        mask = swin_vote.swin_attn_mask(h, w, ws, shift)
        faults["mask not folded"][name] = (
            t if mask is None else t - torch.from_numpy(mask).to(dev)[:, None])
        faults["windows column-major"][name] = t.reshape(
            h // ws, w // ws, *t.shape[1:]).transpose(0, 1).reshape(t.shape)
    other = build_detector(m, None, tc, device=dev,
                           generator=torch.Generator().manual_seed(SEED + 7))
    faults["other weights"] = other.prepare_inference(ex)
    del other
    mods = [attns[name] for name in tables]
    dtypes = [a.dtype for a in mods]
    for a in mods:
        a.dtype = torch.float32
    try:
        faults["RPE in float32"] = det.prepare_inference(ex)
    finally:
        for a, dt in zip(mods, dtypes):
            a.dtype = dt
    return faults


@torch.no_grad()
def static_rpe_phase(dev, card):
    """The per-block route at full width, live frames (attention kernel)
    and static-RPE cached frames (the table in the plain attention) taking
    turns: cache bytes, launches per frame, median frame ms, device busy;
    then the cached frame's head maps and kept boxes against the live plain
    frame and the live kernel frame, and the same readings of planted
    faults, each of which must break a bound."""
    from partner_tpu_torch.models import build_detector

    m, tc = frame_cfgs()
    gen = torch.Generator().manual_seed(SEED)
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    depth = det.module.bbox_head.layer.depth
    pts, mask = synthetic_sweep(np.random.RandomState(SEED),
                                m["bbox_head"]["voxel_generator"]["range"],
                                N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    t0 = time.perf_counter()
    tables = det.prepare_inference(ex)
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(t.nbytes for t in tables.values())
    log(f"static RPE: prepare_inference {fill_ms!r} ms; {len(tables)} tables "
        f"{[tuple(t.shape) for t in tables.values()]}, {nbytes} bytes")
    attns = dict(det.module.named_modules())

    def use(chosen):
        for name in tables:
            attns[name].rpe_table = None if chosen is None else chosen[name]

    wrappers = kernel_wrappers()
    modes = {"live": None, "cached": tables}
    tally = {mode: dict.fromkeys(wrappers, 0) for mode in modes}
    times = {mode: [] for mode in modes}
    outs, maps = {}, {}
    for i in range(FRAMES + 1):  # round 0 warms up; the modes take turns
        for mode in (list(modes) if i % 2 == 0 else list(modes)[::-1]):
            use(modes[mode])
            ms, outs[mode], counts = counted(lambda: det.predict(ex))
            if i:
                times[mode].append(ms)
            for name in wrappers:
                tally[mode][name] += counts[name]
    frames = FRAMES + 1
    res = {"cache_bytes": nbytes}
    for mode in modes:
        attn_n = depth * frames if mode == "live" else 0
        want = {"stem": frames, "scatter_max": frames, "swin_attn": attn_n,
                "swin_block": 0}
        if tally[mode] != want:
            raise AssertionError(f"static RPE {mode}: launches {tally[mode]} "
                                 f"!= {want}")
        use(modes[mode])
        maps[mode] = det.module(ex)
        busy, kernels = device_busy(lambda: det.predict(ex))
        median = statistics.median(times[mode])
        log(f"static RPE, {mode} frames on {card}: median {median!r} ms over "
            f"{FRAMES} (host clock, modes interleaved), all {times[mode]!r}; "
            f"device busy {busy!r} ms and {kernels!r} kernels a frame "
            f"(torch.profiler, 3 frames); launches over {frames} frames "
            f"{tally[mode]}")
        check_detections(outs[mode], tc)
        res[mode] = {"median_ms": median, "device_busy_ms": busy,
                     "kernels": kernels, "launches": tally[mode]}
    # the live plain frame: the fill pass's path, rebuilding the RPE
    use(None)
    for name in tables:
        attns[name].rpe_fill = True
    try:
        outs["plain"], maps["plain"] = det.predict(ex), det.module(ex)
    finally:
        for name in tables:
            attns[name].rpe_fill = False
    for k in sorted(maps["live"]):
        for ref in ("plain", "live"):
            r, max_err = rel_rms_of(k, maps["cached"][k], maps[ref][k])
            log(f"static RPE: cached against live {ref} head map {k}: "
                f"relative RMS {r!r}, max abs err {max_err!r}")
    readings = {}
    for fault, chosen in [("sound", tables)] + list(planted_tables(
            det, tables, ex, m, tc, dev).items()):
        use(chosen)
        out, fmaps = det.predict(ex), det.module(ex)
        plain = static_readings(fmaps, out, maps["plain"], outs["plain"])
        live = static_readings(fmaps, out, maps["live"], outs["live"])
        broken = static_verdict(plain, live)
        readings[fault] = {"plain": plain, "live": live, "broken": broken}
        log(f"static RPE, {fault} table: against the live plain frame "
            f"maps {plain[0]!r} (bound {STATIC_PLAIN_TOL}), kept boxes "
            f"matched {plain[1]!r} (bound 1.0); against the live kernel "
            f"frame maps {live[0]!r} (bound {STATIC_MAP_TOL}), kept boxes "
            f"matched {live[1]!r} (bound {STATIC_MATCH_SHARE}), their "
            f"relative RMS {live[2]!r} (bound {REF_BF16}); bounds broken: "
            f"{broken or 'none'}")
    use(None)
    res["readings"] = readings
    if readings["sound"]["broken"]:
        raise AssertionError("static RPE: the cached frame breaks "
                             f"{readings['sound']['broken']}")
    missed = [f for f, r in readings.items() if f != "sound"
              and not r["broken"]]
    if missed:
        raise AssertionError(f"static RPE: planted faults {missed} pass "
                             "every bound")
    return res


# ---------------------------------------------------------------- train CLI

TRAIN_CLI_FRAMES = 8         # train frames on disk (cut these first)
TRAIN_CLI_SPARSE_BOXES = 12  # every other frame: 6-12 boxes, under the quota
TRAIN_CLI_VAL_FRAMES = 3     # --eval_max_frames


def write_train_set(root, rng, pc_range, n_frames):
    """A synthetic Waymo train set under ``root``, prepared by the port's
    ``create_data``: per frame a :func:`synthetic_scene` of TRAIN_POINTS
    points, the even frames with 32-64 vehicle boxes (above the flagship's
    GT-AUG quota of 15, so nothing is inserted), the odd ones with 6-12
    (GT-AUG tops them up), written as the converter writes a frame
    (``root/train/lidar/seq_0_frame_{i}.pkl`` with ``lidars.points_xyz``
    and ``points_feature``, and under ``annos/`` its objects' ``box`` and
    ``name``); then ``waymo_data_prep`` writes the info pkl and
    ``create_groundtruth_database`` the GT database -> (info path, db info
    path, objects in the database)."""
    import pickle

    from partner_tpu_torch.tools import create_data

    for sub in ("lidar", "annos"):
        os.makedirs(os.path.join(root, "train", sub))
    for i in range(n_frames):
        boxes, xyz = synthetic_scene(
            rng, pc_range, TRAIN_POINTS,
            MAX_BOXES if i % 2 == 0 else TRAIN_CLI_SPARSE_BOXES)
        gt = np.zeros((len(boxes), 9), np.float32)
        gt[:, :6], gt[:, 8] = boxes[:, :6], boxes[:, 6]
        name = f"seq_0_frame_{i}.pkl"
        with open(os.path.join(root, "train", "lidar", name), "wb") as f:
            pickle.dump({"lidars": {
                "points_xyz": xyz.astype(np.float32),
                "points_feature": rng.rand(len(xyz), 2).astype(np.float32)}},
                f)
        with open(os.path.join(root, "train", "annos", name), "wb") as f:
            pickle.dump({"objects": [{"box": b, "name": "Vehicle",
                                      "difficulty": 0} for b in gt]}, f)
    info_path = create_data.waymo_data_prep(root, "train")
    db_info = create_data.create_groundtruth_database("WaymoDataset", root,
                                                      info_path)
    with open(db_info, "rb") as f:
        n_objects = sum(len(v) for v in pickle.load(f).values())
    return info_path, db_info, n_objects


def write_train_config(root, train_info, val_info, db_info):
    """The flagship config file with ``data.train`` / ``data.val`` and the
    GT-AUG database at the synthetic set, ``score_threshold`` 0 (as
    :func:`frame_cfgs`), and a metrics record every step (the log still
    flushes every ``log_config.interval`` steps). GT-AUG, its quota and
    filters, and the augmentations stay as the config has them."""
    path = os.path.join(root, "train_cfg.py")
    with open(path, "w") as f:
        f.write(f"exec(open({CONFIG!r}).read())\n"
                "test_cfg['score_threshold'] = 0.0\n"
                f"db_sampler['db_info_path'] = {db_info!r}\n"
                f"data['train'].update(info_path={train_info!r}, "
                f"root_path={root!r})\n"
                f"data['val'].update(info_path={val_info!r}, "
                f"root_path={root!r})\n"
                "log_config['hooks'] = log_config['hooks'] + "
                "[dict(type='MetricsSinkHook', interval=1)]\n")
    return path


def host_pipeline_ms(cfg_path, repeat=8):
    """The train data path alone on the host: ms per sample of
    ``dataset[i]`` (load, GT-AUG, augmentations, shuffle, targets) in one
    thread over the train frames, ms to collate the first 4 into
    TRAIN_ROWS rows, and the loader's batches of 4 per second with the
    config's ``workers_per_gpu`` threads over the frames repeated
    ``repeat`` times (no card work beside it)."""
    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.collate import collate
    from partner_tpu_torch.data.datasets import RepeatDataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(cfg_path)
    ds = build_dataset(dict(cfg["data"]["train"]),
                       dict(rng=np.random.RandomState(SEED)))
    items, ms = [], []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        items.append(ds[i])
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    collate(items[:4], max_points=TRAIN_ROWS)
    collate_ms = (time.perf_counter() - t0) * 1e3
    threads = cfg["data"]["workers_per_gpu"]
    loader = DataLoader(RepeatDataset(ds, repeat), 4, num_workers=threads,
                        max_points=TRAIN_ROWS)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return ms, collate_ms, (n / (time.perf_counter() - t0), n, threads)


def native_sample_ms(cfg_path, passes=2):
    """The train data path with and without the native library, sample by
    sample: two datasets seeded alike (the library and the numpy bodies
    give the same draws), ``dataset[i]`` of each in turn (which goes first
    alternates), ``passes`` passes over the frames (the first reads them
    from disk) -> {True: library, False: numpy} of (ms per sample of the
    last pass, ms of that pass spent in GT-AUG's collision test)."""
    from contextlib import nullcontext

    from partner_tpu_torch import native
    from partner_tpu_torch.data import build_dataset, gt_aug
    from partner_tpu_torch.utils.config import load_config

    train = dict(load_config(cfg_path)["data"]["train"])
    test = gt_aug.box_collision_test
    spent = {}

    def timed_test(a, b):
        t0 = time.perf_counter()
        out = test(a, b)
        key = native.available()
        spent[key] = spent.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    gt_aug.box_collision_test = timed_test
    try:
        for _ in range(passes):
            ds = {lib: build_dataset(dict(train),
                                     dict(rng=np.random.RandomState(SEED)))
                  for lib in (True, False)}
            ms, spent = {True: [], False: []}, {}
            for i in range(len(ds[True])):
                for lib in ((True, False) if i % 2 == 0 else (False, True)):
                    with nullcontext() if lib else native.numpy_only():
                        t0 = time.perf_counter()
                        ds[lib][i]
                        ms[lib].append((time.perf_counter() - t0) * 1e3)
    finally:
        gt_aug.box_collision_test = test
    return {lib: (ms[lib], spent.get(lib, 0.0)) for lib in (True, False)}


def train_cli_phase(dev, card):
    """``partner_tpu_torch.tools.train.main`` on the card at full width and
    batch 4 over a synthetic Waymo train set with GT-AUG from a database cut
    from it: 4 steps in 2 epochs with a checkpoint and a validation after
    each, then a second run to step 6 that resumes from ``latest`` at step
    4 with the Adam state of the checkpoint. Readings: step times and the
    data share, GT-AUG boxes inserted per sample, peak memory, finite
    losses and gradient norms every step, the validation metrics, and the
    kernels' launches per train step and per validation frame."""
    import json as _json
    import tempfile
    import threading

    from partner_tpu_torch.data import gt_aug
    from partner_tpu_torch.eval import evaluator
    from partner_tpu_torch.models.detectors import E2EDetector
    from partner_tpu_torch.tools import train
    from partner_tpu_torch.train import checkpoint

    m, _ = frame_cfgs()
    pc_range = m["bbox_head"]["voxel_generator"]["range"]
    depth = m["bbox_head"]["HEAD_CONFIG"]["sl_depth"][0]
    wrappers = kernel_wrappers()
    inserted, val_results, resumed, peaks = [], [], [], []
    val_launches = dict.fromkeys(wrappers, 0)
    lock = threading.Lock()
    sample_all, predict = gt_aug.DataBaseSampler.sample_all, E2EDetector.predict
    evaluate, restore = evaluator.evaluate, checkpoint.restore_train_state

    def counting_sample_all(self, *args, **kwargs):
        out = sample_all(self, *args, **kwargs)
        with lock:
            inserted.append(0 if out is None else len(out["gt_boxes"]))
        return out

    def counting_predict(self, example):
        before = {k: fn.launches for k, fn in wrappers.items()}
        out = predict(self, example)
        for k, fn in wrappers.items():
            val_launches[k] += fn.launches - before[k]
        return out

    def recording_evaluate(*args, **kwargs):
        # the peak memory of the steps before it, and of the validation
        peaks.append(("train", torch.cuda.max_memory_allocated() / 2 ** 30))
        torch.cuda.reset_peak_memory_stats()
        result, fps = evaluate(*args, **kwargs)
        peaks.append(("val", torch.cuda.max_memory_allocated() / 2 ** 30))
        torch.cuda.reset_peak_memory_stats()
        val_results.append(result[0])
        return result, fps

    def checked_restore(det, opt, payload):
        step = restore(det, opt, payload)
        names = [n for n, _ in det.module.named_parameters()]
        st, got = payload["opt_state"], opt.state_dict()
        same = all(torch.equal(got[key][i].cpu(), st[key][n])
                   for key in ("mu", "nu") for i, n in enumerate(names))
        resumed.append((step, got["count"], same))
        return step

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rng = np.random.RandomState(SEED + 6)
        train_info, db_info, n_objects = write_train_set(
            root, rng, pc_range, TRAIN_CLI_FRAMES)
        val_root = os.path.join(root, "val")
        os.makedirs(val_root)
        val_info = write_val_set(val_root, rng, pc_range,
                                 TRAIN_CLI_VAL_FRAMES)
        cfg = write_train_config(root, train_info, val_info, db_info)
        log(f"train CLI: {TRAIN_CLI_FRAMES} train frames of {TRAIN_POINTS} "
            f"points, a GT database of {n_objects} objects, "
            f"{TRAIN_CLI_VAL_FRAMES} val frames, written in "
            f"{time.perf_counter() - t0!r} s")
        work_dir = os.path.join(root, "work")
        common = [cfg, "--work_dir", work_dir, "--batch_size", "4",
                  "--max_steps_per_epoch", "2", "--validate",
                  "--eval_max_frames", str(TRAIN_CLI_VAL_FRAMES),
                  "--max_points", str(TRAIN_ROWS), "--seed", str(SEED),
                  "--device", torch.device(dev).type]
        gt_aug.DataBaseSampler.sample_all = counting_sample_all
        E2EDetector.predict = counting_predict
        evaluator.evaluate = recording_evaluate
        checkpoint.restore_train_state = checked_restore
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            def both_runs():
                walls = []
                for total in (4, 6):
                    t0 = time.perf_counter()
                    if train.main(common + ["--total_steps",
                                            str(total)]) != total:
                        raise AssertionError(
                            f"train CLI: did not reach {total}")
                    walls.append(time.perf_counter() - t0)
                return walls

            _, walls, launches = counted(both_runs)
        finally:
            gt_aug.DataBaseSampler.sample_all = sample_all
            E2EDetector.predict = predict
            evaluator.evaluate = evaluate
            checkpoint.restore_train_state = restore
        peaks.append(("end", torch.cuda.max_memory_allocated() / 2 ** 30))
        peak = max(p for _, p in peaks)
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            recs = [_json.loads(line) for line in f]
        ckpts = sorted(d for d in os.listdir(work_dir) if d.startswith("ckpt_"))
        sample_ms, collate_ms, (rate, n_batches, threads) = (
            host_pipeline_ms(cfg))
        from partner_tpu_torch import native

        with native.numpy_only():
            _, _, (rate_np, _, _) = host_pipeline_ms(cfg)
        paired = native_sample_ms(cfg)
    if [r["step"] for r in recs] != list(range(6)):
        raise AssertionError(f"train CLI: steps {[r['step'] for r in recs]}")
    if resumed != [(4, 4, True)]:
        raise AssertionError(f"train CLI: resume (step, count, moments equal)"
                             f" {resumed} != [(4, 4, True)]")
    if ckpts != ["ckpt_00000002", "ckpt_00000004", "ckpt_00000006"]:
        raise AssertionError(f"train CLI: checkpoints {ckpts}")
    for r in recs:
        vals = {k: v for k, v in r.items()
                if k.startswith("loss") or k in ("grad_norm", "num_matched")}
        log(f"train CLI step {r['step']} (epoch {r['epoch']}, lr "
            f"{r['lr']!r}): time {r['time']!r} s, data_time "
            f"{r['data_time']!r} s, " + ", ".join(
                f"{k} {v!r}" for k, v in sorted(vals.items())))
        if not all(np.isfinite(v) for v in vals.values()) or not (
                vals["grad_norm"] > 0 and vals["num_matched"] > 0):
            raise AssertionError(f"train CLI step {r['step']}: {vals}")
    n_val = len(val_results) * TRAIN_CLI_VAL_FRAMES
    train_launches = {k: launches[k] - val_launches[k] for k in wrappers}
    want_train = {"stem": 0, "scatter_max": 6, "swin_attn": 0,
                  "swin_block": 0}
    want_val = {"stem": n_val, "scatter_max": n_val,
                "swin_attn": depth * n_val, "swin_block": 0}
    log(f"train CLI launches: 6 train steps {train_launches}, {n_val} val "
        f"frames {val_launches}")
    if train_launches != want_train or val_launches != want_val:
        raise AssertionError(f"train CLI launches: train {train_launches} != "
                             f"{want_train} or val {val_launches} != "
                             f"{want_val}")
    for epoch, met in enumerate(val_results, 1):
        log(f"train CLI [val] epoch {epoch}: " + ", ".join(
            f"{k} {met[k]!r}" for k in sorted(met) if "/[" not in k))
        if not all(np.isfinite(met[k]) for k in ("mAP/L1", "mAPH/L2")):
            raise AssertionError(f"train CLI [val] epoch {epoch}: {met}")
    if len(val_results) != 3:
        raise AssertionError(f"train CLI: {len(val_results)} validations")
    # the first step of each run builds the detector's lazy state and the
    # loader's first batch; the median is over the other 4
    steady = [r for r in recs if r["step"] not in (0, 4)]
    median = statistics.median(r["time"] for r in steady)
    data_share = (sum(r["data_time"] for r in steady)
                  / sum(r["time"] for r in steady))
    log(f"train CLI on {card}: median step time {median!r} s (the CLI's "
        f"`time`: data + transfer + the step's host time; the pageable copy "
        f"of a batch waits for the card's last step), data_time "
        f"{[r['data_time'] for r in steady]!r} s in steps 1-3 and 5, "
        f"{data_share!r} of their summed time (the first step of each "
        f"2-step epoch waits for a new loader's first batch); runs of 4 and "
        f"2 steps, wall {walls!r} s (build, steps, checkpoints, "
        f"validations); GT-AUG boxes inserted per sample {inserted!r} (mean "
        f"{statistics.mean(inserted)!r}); peak memory {peak!r} GiB (GiB "
        f"by span: {peaks!r}); resumed at step 4 with count 4 and the "
        f"moments of the checkpoint")
    log(f"train CLI host data path alone, one thread: dataset[i] "
        f"{sample_ms!r} ms a sample (median {statistics.median(sample_ms)!r}"
        f"), collate of 4 {collate_ms!r} ms; a batch of 4 needs "
        f"{4 * statistics.median(sample_ms) + collate_ms!r} ms of one "
        f"thread against a {median * 1e3!r} ms step; the loader alone with "
        f"{threads} threads: {rate!r} batches of 4 a second over "
        f"{n_batches} batches, against the {1 / median!r} a second the "
        f"steps take")
    (lib_ms, lib_test), (np_ms, np_test) = paired[True], paired[False]
    log(f"train CLI host data path with and without the native library, "
        f"sample by sample in turns (second pass over the frames), one "
        f"thread: dataset[i] {lib_ms!r} ms with it (median "
        f"{statistics.median(lib_ms)!r}), {np_ms!r} ms with the numpy "
        f"bodies (median {statistics.median(np_ms)!r}); GT-AUG's collision "
        f"test took {lib_test!r} ms of the pass with it, {np_test!r} ms "
        f"without ({np_test / sum(np_ms)!r} of the numpy pass); the loader "
        f"with {threads} threads and the numpy bodies {rate_np!r} batches of "
        f"4 a second ({rate!r} with the library)")
    return dict(launches=launches, median_s=median, data_share=data_share,
                inserted=statistics.mean(inserted), peak=peak, walls=walls,
                sample_ms=statistics.median(sample_ms), loader_rate=rate,
                sample_ms_lib=statistics.median(lib_ms),
                sample_ms_numpy=statistics.median(np_ms),
                loader_rate_numpy=rate_np)


# ---------------------------------------------------------------- CenterPoint

CP_CONFIG = os.path.join(ROOT, "configs", "waymo",
                         "waymo_centerpoint_voxelnet_36epoch.py")
CP_VELO_CONFIG = os.path.join(
    ROOT, "configs", "waymo",
    "waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py")
CP_CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
CP_VELO_FRAMES = 5           # timed two-sweep frames after one warm-up
CP_EVAL_FRAMES = 10          # synthetic 3-class val frames (cut first)


def centerpoint_cfgs(config=CP_CONFIG, grid=None, compute_dtype=None):
    """(model cfg, train cfg, test cfg) of a CenterPoint config (or a
    two-stage one, at its own grid and dtypes), with ``score_threshold`` 0
    (as :func:`frame_cfgs`), optionally on another grid (same widths) or
    with every compute dtype replaced."""
    import copy

    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(config)
    m = copy.deepcopy(cfg["model"])
    tc = copy.deepcopy(cfg["test_cfg"])
    tc["score_threshold"] = 0.0
    if grid is not None:
        vg = m["bbox_head"]["voxel_generator"]
        r = vg["range"]
        vg["voxel_size"] = [(r[3 + i] - r[i]) / grid[i] for i in range(3)]
    if compute_dtype is not None:
        m["backbone"]["compute_dtype"] = compute_dtype
        m["neck"]["compute_dtype"] = compute_dtype
    return m, copy.deepcopy(cfg["train_cfg"]), tc


def timed_predicts(det, ex, frames, want, run=None):
    """``frames`` timed predicts after one warm-up (``run()`` in place of
    ``det.predict(ex)`` where given), each :func:`counted` and launching
    ``want`` -> (median host ms, all ms, the last output, launches summed
    over the timed frames)."""
    times, tally, out = [], dict.fromkeys(want, 0), None
    run = run or (lambda: det.predict(ex))
    for i in range(frames + 1):
        ms, out, counts = counted(run)
        if counts != want:
            raise AssertionError(f"frame {i}: launches {counts} != {want}")
        if i:
            times.append(ms)
            for k in tally:
                tally[k] += counts[k]
    return statistics.median(times), times, out, tally


@torch.no_grad()
def centerpoint_reference(dev, card):
    """The CenterPoint widths on SMALL_GRID, same weights and points: the
    backbone BEV and each head map of the card (bf16 backbone with the
    stem and scatter kernels) against the CPU (float32, plain twins), each
    stage fed the CPU's input."""
    from partner_tpu_torch.models import build_detector

    m, _, tc = centerpoint_cfgs(grid=SMALL_GRID)
    gen = torch.Generator().manual_seed(SEED + 7)
    gpu = build_detector(m, None, tc, device=dev, generator=gen).module
    randomize_norms(gpu, gen)
    m32, _, _ = centerpoint_cfgs(grid=SMALL_GRID, compute_dtype="float32")
    cpu = build_detector(m32, None, tc, device="cpu").module
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    pts, mask = synthetic_sweep(np.random.RandomState(SEED + 7),
                                m["bbox_head"]["voxel_generator"]["range"],
                                30_000)
    exc = to_device({"points": pts, "points_mask": mask}, "cpu")
    exg = to_device({"points": pts, "points_mask": mask}, dev)
    bev = cpu.backbone.encode_points(exc["points"], exc["points_mask"],
                                     cpu.grid_size, cpu.pc_range)
    rel_rms(f"CenterPoint backbone BEV on {card}",
            gpu.backbone.encode_points(exg["points"], exg["points_mask"],
                                       gpu.grid_size, gpu.pc_range),
            bev, REF_BF16)
    want = cpu.bbox_head(cpu.neck(bev))["det_preds"][0]
    got = gpu.bbox_head(gpu.neck(bev.to(dev)))["det_preds"][0]
    for k in sorted(want):
        rel_rms(f"CenterPoint RPN + head {k}", got[k], want[k], REF_BF16)


def write_centerpoint_config(root, info_path):
    """The CenterPoint config file with ``score_threshold`` 0 (as
    :func:`centerpoint_cfgs`), ``data.train`` and ``data.val`` at
    ``info_path``, and a metrics record every step."""
    path = os.path.join(root, "centerpoint_cfg.py")
    with open(path, "w") as f:
        f.write(f"exec(open({CP_CONFIG!r}).read())\n"
                "test_cfg['score_threshold'] = 0.0\n"
                f"for _s in ('train', 'val'):\n"
                f"    data[_s].update(info_path={info_path!r}, "
                f"root_path={root!r})\n"
                "log_config['hooks'] = log_config['hooks'] + "
                "[dict(type='MetricsSinkHook', interval=1)]\n")
    return path


def centerpoint_phase(dev, card):
    """The Waymo CenterPoint family on the card at full width: the
    one-sweep frame, the card against the CPU on a small grid, the
    two-sweep velocity frame (the stem at C_in 11), the batch-4 train step,
    and both entry points (dist_test from a port checkpoint; two train-CLI
    steps)."""
    import json as _json
    import tempfile

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.tools import dist_test, train
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    res = {}
    per_frame = {"stem": 1, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    # ---- the one-sweep frame
    m, train_cfg, tc = centerpoint_cfgs()
    gen = torch.Generator().manual_seed(SEED + 6)
    t0 = time.perf_counter()
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    n_params = sum(p.numel() for p in det.module.parameters())
    log(f"CenterPoint detector: grid {det.module.grid_size}, {n_params} "
        f"params, built in {time.perf_counter() - t0:.1f} s")
    pr = m["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_sweep(np.random.RandomState(SEED), pr, N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    median, times, out, tally = timed_predicts(det, ex, FRAMES,
                                                   per_frame)
    busy, kernels = device_busy(lambda: det.predict(ex))
    with torch.no_grad():
        maps = det.module(ex)["det_preds"][0]
    if not all(torch.isfinite(v).all() for v in maps.values()):
        raise AssertionError("CenterPoint frame: non-finite head maps")
    kept = check_detections(out, tc)
    log(f"CenterPoint frame on {card}: median {median!r} ms over {FRAMES} "
        f"frames (host clock around a synchronized predict), all {times!r}; "
        f"device busy {busy!r} ms and {kernels!r} launches a frame "
        f"(torch.profiler, 3 frames); kernel launches over {FRAMES} frames "
        f"{tally}; {kept} boxes kept; maps {sorted(maps)} finite")
    res["frame"] = dict(median_ms=median, device_busy_ms=busy,
                        launches_per_frame=kernels, launches=tally,
                        kept=kept)
    del det, maps, out
    torch.cuda.empty_cache()

    centerpoint_reference(dev, card)

    # ---- the two-sweep velocity frame: 8 features, the stem at C_in 11
    mv, _, tcv = centerpoint_cfgs(CP_VELO_CONFIG)
    gen = torch.Generator().manual_seed(SEED + 8)
    det = build_detector(mv, None, tcv, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    pts, mask = synthetic_sweep(np.random.RandomState(SEED + 8), pr,
                                2 * N_POINTS, c=8)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    median, times, out, tally = timed_predicts(det, ex, CP_VELO_FRAMES,
                                                   per_frame)
    with torch.no_grad():
        maps = det.module(ex)["det_preds"][0]
    if "vel" not in maps or not torch.isfinite(maps["vel"]).all():
        raise AssertionError("two-sweep frame: vel map missing or not finite")
    kept = check_detections(out, tcv, box_dim=9)
    log(f"CenterPoint two-sweep frame on {card}: {2 * N_POINTS} points in "
        f"{pts.shape[1]} rows, 8 features (stem C_in 11): median {median!r} "
        f"ms over {CP_VELO_FRAMES} frames, all {times!r}; launches {tally}; "
        f"{kept} boxes kept (9 columns, velocity); vel map finite")
    res["two_sweep"] = dict(median_ms=median, launches=tally, kept=kept)
    del det, maps, out
    torch.cuda.empty_cache()

    # ---- the train step at batch 4
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(SEED + 9)
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    cfg = load_config(CP_CONFIG)
    batch = cfg["data"]["samples_per_gpu"]
    ex = to_device(centerpoint_train_example(
        np.random.RandomState(SEED + 9), m, train_cfg, batch, TRAIN_POINTS,
        TRAIN_ROWS, MAX_BOXES), dev)
    log(f"CenterPoint train batch: {batch} samples of {TRAIN_POINTS} points "
        f"in {TRAIN_ROWS} rows, {[int(t.sum()) for t in ex['mask'][0]]} "
        f"center targets")
    step = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max=cfg["lr_config"]["lr_max"], total_steps=1000))
    want = {"stem": 0, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    launches, median, times, _, peak = timed_train_steps(
        det, step, ex, None, want, "CenterPoint train step")
    log(f"CenterPoint train step, batch {batch}, on {card}: median {median!r} "
        f"ms over {TRAIN_STEPS} steps (host clock around a synchronized "
        f"step), all {times!r}; peak memory {peak!r} GiB; launches over "
        f"{TRAIN_STEPS + 1} steps {launches}; every gradient finite, every "
        "parameter and BatchNorm statistic moved")
    res["train"] = dict(median_ms=median, peak_gib=peak, launches=launches)

    # ---- the entry points
    with tempfile.TemporaryDirectory() as root:
        info_path = write_val_set(root, np.random.RandomState(SEED + 10), pr,
                                  CP_EVAL_FRAMES, names=CP_CLASSES)
        cfg_path = write_centerpoint_config(root, info_path)
        save_checkpoint(os.path.join(root, "ckpt"), 0,
                        det.module.state_dict())
        del det, step, ex
        torch.cuda.empty_cache()
        _, ((metrics, _), fps), eval_launches = counted(
            lambda: dist_test.main([
                cfg_path, "--checkpoint",
                os.path.join(root, "ckpt", "latest"), "--work_dir",
                os.path.join(root, "eval"), "--max_points", str(EVAL_ROWS),
                "--device", torch.device(dev).type]))
        want = {k: n * CP_EVAL_FRAMES for k, n in per_frame.items()}
        if eval_launches != want:
            raise AssertionError(f"CenterPoint dist_test: launches "
                                 f"{eval_launches} != {want}")
        keys = [f"AP/L1/{c}" for c in CP_CLASSES] + ["mAP/L1", "mAPH/L2"]
        for k in keys:
            if k not in metrics or not np.isfinite(metrics[k]):
                raise AssertionError(f"CenterPoint dist_test: {k} missing or "
                                     "not finite")
        log(f"CenterPoint dist_test on {card}: middle-third FPS {fps!r} over "
            f"{CP_EVAL_FRAMES} frames of {N_POINTS} points in {EVAL_ROWS} "
            f"rows; launches {eval_launches}; " + ", ".join(
                f"{k} {metrics[k]!r}" for k in keys))
        res["dist_test"] = dict(fps=fps, launches=eval_launches)

        work_dir = os.path.join(root, "train")
        wall_ms, steps, cli_launches = counted(lambda: train.main([
            cfg_path, "--work_dir", work_dir, "--batch_size", "4",
            "--total_steps", "2", "--max_steps_per_epoch", "2",
            "--max_points", str(TRAIN_ROWS), "--seed", str(SEED),
            "--device", torch.device(dev).type]))
        wall = wall_ms / 1e3
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            recs = [_json.loads(line) for line in f]
        ckpts = sorted(d for d in os.listdir(work_dir)
                       if d.startswith("ckpt_"))
    if steps != 2 or ckpts != ["ckpt_00000002"] or [
            r["step"] for r in recs] != [0, 1]:
        raise AssertionError(f"CenterPoint train CLI: steps {steps}, "
                             f"checkpoints {ckpts}, records {recs}")
    if cli_launches != {"stem": 0, "scatter_max": 2, "swin_attn": 0,
                        "swin_block": 0}:
        raise AssertionError(f"CenterPoint train CLI: launches {cli_launches}")
    for r in recs:
        vals = {k: r[k] for k in ("loss", "hm_loss", "loc_loss", "det_loss",
                                  "grad_norm")}
        log(f"CenterPoint train CLI step {r['step']} on {card}: time "
            f"{r['time']!r} s, data_time {r['data_time']!r} s, {vals}")
        flat = [x for v in vals.values()
                for x in (v if isinstance(v, list) else [v])]
        if not all(np.isfinite(flat)):
            raise AssertionError(f"CenterPoint train CLI: {vals}")
    log(f"CenterPoint train CLI: 2 steps at batch 4 and one checkpoint in "
        f"{wall!r} s (build, data, steps, checkpoint)")
    res["train_cli"] = dict(launches=cli_launches, wall_s=wall)
    return res


# ---------------------------------------------------------------- two-stage

TS_CONFIG = os.path.join(
    ROOT, "configs", "waymo", "two_stage",
    "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py")
TS_VELO_CONFIG = os.path.join(
    ROOT, "configs", "waymo", "two_stage",
    "waymo_centerpoint_voxelnet_two_sweep_two_stage_bev_5point_ft_6epoch_"
    "freeze_with_vel.py")
TS_FRAMES = 6                # timed frames of each detector, taking turns
TS_VELO_FRAMES = 3           # timed two-sweep frames after one warm-up
TS_PREP_FRAMES = 4           # fake Waymo frames through create_data
RANGE_IMAGE = (64, 2650)     # the Waymo TOP lidar's range image, H x W
TOP_INCLINATION = (-0.3078, 0.0420)   # its beams' span, radians
TS_SIZES = {1: ("Vehicle", (4.5, 2.0, 1.6)), 2: ("Pedestrian", (0.8, 0.8, 1.8)),
            4: ("Cyclist", (1.8, 0.7, 1.7))}


def plant_positives(det, ex, dev, n=8):
    """Random first stages propose boxes that overlap no synthetic gt, so
    the RoI regression would see no positive: the first ``n`` gt rows of
    each sample become copies, shifted by 5% of their size, of every third
    of the top proposals the frozen (eval-mode) first stage makes on these
    points, in their class 1."""
    with torch.no_grad():
        preds, _ = det.module(to_device(
            {k: ex[k] for k in ("points", "points_mask")}, dev))
        boxes, scores = det.decode_proposals(preds["det_preds"][0])
        top = torch.sort(scores.amax(-1), dim=1, descending=True,
                         stable=True).indices[:, : 3 * n: 3]
        props = torch.take_along_dim(boxes, top[..., None], 1).cpu().numpy()
    gb = ex["global_box"]
    gb[:, :n, :6], gb[:, :n, 8] = props[..., :6], props[..., -1]
    gb[:, :n, :2] += 0.05 * props[..., 3:5]
    gb[:, :n, 9] = 1
    ex["global_box_mask"] = gb[..., -1] > 0
    return ex


def fake_waymo_frame(rng, frame_id, n_objects=40):
    """A Waymo frame as ``data.waymo_decoder`` reads one (dicts in place of
    the protos, numpy range images in place of zlib payloads): the TOP
    lidar's 64 x 2650 range image mounted 2 m up, ranges log-uniform over
    2-75 m and cut where a downward beam meets the ground, 2% of pixels in
    the no-label zone, a second return on 10% of pixels, the per-pixel
    pose of a car moving 10 m a frame (the rolling-shutter path), and
    ``n_objects`` labels of the three classes in turn centered on returns
    of the first."""
    from partner_tpu_torch.data import waymo_decoder as wd

    h, w = RANGE_IMAGE
    ext = np.eye(4)
    ext[2, 3] = 2.0
    incl = wd.compute_inclination(*TOP_INCLINATION, h)[::-1]
    ground = 2.0 / np.maximum(-np.sin(incl), 1e-3)
    ri1 = np.stack([
        np.minimum(np.exp(rng.uniform(np.log(2.0), np.log(75.0), (h, w))),
                   ground[:, None]),
        rng.rand(h, w), rng.rand(h, w) * 0.2,
        np.where(rng.rand(h, w) < 0.02, 1.0, -1.0)], -1)
    ri2 = ri1.copy()
    ri2[..., 0] = np.where(rng.rand(h, w) < 0.1, ri1[..., 0] * 1.05, 0.0)
    pose_ri = np.zeros((h, w, 6))
    pose_ri[..., 3] = 10.0 * frame_id + np.linspace(0.5, -0.5, w)[None]
    frame_pose = np.eye(4)
    frame_pose[0, 3] = 10.0 * frame_id
    pts = wd.decode_range_image(ri1, ext, incl)
    rho = np.hypot(pts[:, 0], pts[:, 1])
    cand = pts[(rho > 5) & (rho < 70) & (np.abs(pts[:, 2]) < 1.5)]
    centers = cand[rng.choice(len(cand), n_objects, replace=False)]
    labels = []
    for j, c in enumerate(centers):
        kind = (1, 2, 4)[j % 3]
        dims = TS_SIZES[kind][1]
        labels.append({
            "id": f"obj{j}", "type": kind,
            "box": {"center_x": c[0], "center_y": c[1], "center_z": c[2],
                    "length": dims[0], "width": dims[1], "height": dims[2],
                    "heading": rng.uniform(-np.pi, np.pi)},
            "metadata": {"speed_x": rng.randn(), "speed_y": rng.randn(),
                         "accel_x": 0.0, "accel_y": 0.0},
            "num_lidar_points_in_box": 10,
            "detection_difficulty_level": 0})
    return {
        "context": {"name": "synthetic", "stats": {
            "location": "synthetic", "time_of_day": "Day"},
            "laser_calibrations": [{
                "name": 1, "extrinsic": {"transform": list(ext.ravel())},
                "beam_inclinations": [],
                "beam_inclination_min": TOP_INCLINATION[0],
                "beam_inclination_max": TOP_INCLINATION[1]}]},
        "timestamp_micros": 1_000_000 + 100_000 * frame_id,
        "pose": {"transform": list(frame_pose.ravel())},
        "lasers": [{"name": 1,
                    "ri_return1": {"range_image": ri1,
                                   "range_image_pose_compressed": pose_ri},
                    "ri_return2": {"range_image": ri2}}],
        "laser_labels": labels,
    }


def write_two_stage_config(root, info_path, db_info, pretrained):
    """The frozen two-stage config file at full width with the first
    stage's ``pretrained`` at ``pretrained``, ``score_threshold`` 0,
    ``data.train`` and ``data.val`` at ``info_path``, GT-AUG from
    ``db_info`` (15 vehicles, 10 pedestrians, 10 cyclists a sample, at
    least 5 points each; the CenterPoint configs have none of their own),
    and a metrics record every step."""
    path = os.path.join(root, "two_stage_cfg.py")
    db = dict(type="GT-AUG", enable=True, db_info_path=db_info,
              sample_groups=[dict(Vehicle=15), dict(Pedestrian=10),
                             dict(Cyclist=10)],
              db_prep_steps=[dict(filter_by_min_num_points=dict(
                  Vehicle=5, Pedestrian=5, Cyclist=5)),
                  dict(filter_by_difficulty=[-1])],
              global_random_rotation_range_per_object=[0, 0], rate=1.0)
    with open(path, "w") as f:
        # the config's own path, for the sibling file it reads
        f.write(f"__file__ = {TS_CONFIG!r}\n"
                f"exec(open({TS_CONFIG!r}).read())\n"
                f"model['first_stage_cfg']['pretrained'] = {pretrained!r}\n"
                "test_cfg['score_threshold'] = 0.0\n"
                "for _s in ('train', 'val'):\n"
                f"    data[_s].update(info_path={info_path!r}, "
                f"root_path={root!r})\n"
                "for _p in data['train']['pipeline']:\n"
                "    if _p['type'] == 'Preprocess':\n"
                f"        _p['cfg']['db_sampler'] = {db!r}\n"
                "log_config['hooks'] = log_config['hooks'] + "
                "[dict(type='MetricsSinkHook', interval=1)]\n")
    return path


def two_stage_prep_and_cli(dev, card, m, train_cfg, tc):
    """The card's host prepares a Waymo set with the port's ``create_data``
    (converter, infos, GT database) from TS_PREP_FRAMES fake frames; a
    seeded one-stage CenterPoint checkpoint is saved; two train-CLI steps
    of the frozen two-stage config run from it through ``pretrained`` on
    that set with GT-AUG from that database; then ``dist_test`` from the
    CLI's checkpoint over the same frames, each bit-equal to a direct
    ``predict``."""
    import json as _json
    import pickle
    import tempfile

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.tools import create_data, dist_test, train
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from partner_tpu_torch.utils.config import load_config

    res = {}
    rng = np.random.RandomState(SEED + 12)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        frames = [fake_waymo_frame(rng, i) for i in range(TS_PREP_FRAMES)]
        record = os.path.join(root, "records.pkl")
        with open(record, "wb") as f:
            pickle.dump(frames, f)
        del frames
        make_s = time.perf_counter() - t0
        prep = {}
        t0 = time.perf_counter()
        create_data.main(["waymo_convert", "--record_path", record,
                          "--root_path", root])
        prep["waymo_convert"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info_path = create_data.main(["waymo_data_prep", "--root_path",
                                      root])
        prep["waymo_data_prep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        db_info = create_data.main(["create_groundtruth_database",
                                    "--root_path", root, "--info_path",
                                    info_path])
        prep["create_groundtruth_database"] = time.perf_counter() - t0
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        with open(db_info, "rb") as f:
            db = pickle.load(f)
        n_pts = [len(pickle.load(open(i["path"], "rb"))["lidars"][
            "points_xyz"]) for i in infos]
        per_frame_ms = {k: v * 1e3 / TS_PREP_FRAMES for k, v in prep.items()}
        if len(infos) != TS_PREP_FRAMES or sorted(db) != sorted(
                ["Cyclist", "Pedestrian", "Vehicle"]) or max(n_pts) > EVAL_ROWS:
            raise AssertionError(f"create_data: {len(infos)} infos, db "
                                 f"{sorted(db)}, points {n_pts}")
        log(f"two-stage data prep on the card's host: {TS_PREP_FRAMES} fake "
            f"Waymo frames ({RANGE_IMAGE[0]} x {RANGE_IMAGE[1]} TOP range "
            f"image, two returns, rolling shutter; made in {make_s!r} s) -> "
            f"{n_pts} points a frame; ms a frame: {per_frame_ms!r}; GT "
            f"database {({k: len(v) for k, v in db.items()})} objects")
        res["prep_ms"] = per_frame_ms

        gen = torch.Generator().manual_seed(SEED + 13)
        one = build_detector(m["first_stage_cfg"], None, tc, device=dev,
                             generator=gen)
        randomize_norms(one.module, gen)
        pretrained = os.path.join(root, "one_stage", "latest")
        save_checkpoint(os.path.dirname(pretrained), 0,
                        one.module.state_dict())
        del one
        torch.cuda.empty_cache()
        cfg_path = write_two_stage_config(root, info_path, db_info,
                                          pretrained)
        work_dir = os.path.join(root, "train")
        wall_ms, steps, cli_launches = counted(lambda: train.main([
            cfg_path, "--work_dir", work_dir, "--batch_size", "4",
            "--total_steps", "2", "--max_steps_per_epoch", "1",
            "--max_points", str(EVAL_ROWS), "--seed", str(SEED),
            "--device", torch.device(dev).type]))
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            recs = [_json.loads(line) for line in f]
        want = {"stem": 2, "scatter_max": 2, "swin_attn": 0, "swin_block": 0}
        if steps != 2 or [r["step"] for r in recs] != [0, 1] or (
                cli_launches != want):
            raise AssertionError(f"two-stage train CLI: steps {steps}, "
                                 f"records {recs}, launches {cli_launches}")
        for r in recs:
            vals = {k: r[k] for k in ("loss", "roi_cls_loss", "roi_reg_loss",
                                      "grad_norm")}
            log(f"two-stage train CLI step {r['step']} on {card}: time "
                f"{r['time']!r} s, data_time {r['data_time']!r} s, {vals}")
            if not all(np.isfinite(list(vals.values()))):
                raise AssertionError(f"two-stage train CLI: {vals}")
        ckpt = os.path.join(work_dir, "latest")
        payload = load_checkpoint(ckpt)[0]
        pre = load_checkpoint(pretrained)[0]["state_dict"]
        moved = [k for k in pre if not torch.equal(
            payload["state_dict"]["first." + k], pre[k])]
        if moved or sorted(payload["opt_state"]["mu"]) != sorted(
                k for k in payload["state_dict"] if k.startswith("roi_head.")):
            raise AssertionError(f"two-stage train CLI: first stage moved "
                                 f"{moved[:5]} or Adam state not the RoI "
                                 "head's")
        log(f"two-stage train CLI: 2 steps at batch 4 from the pretrained "
            f"one-stage checkpoint in {wall_ms / 1e3!r} s (build, load, "
            f"data, steps, checkpoints); launches {cli_launches}; the first "
            "stage bit-equal to the checkpoint's, Adam moments the RoI "
            "head's alone")
        res["train_cli"] = dict(launches=cli_launches, wall_s=wall_ms / 1e3)

        _, ((metrics, _), fps), eval_launches = counted(
            lambda: dist_test.main([
                cfg_path, "--checkpoint", ckpt, "--work_dir",
                os.path.join(root, "eval"), "--max_points", str(EVAL_ROWS),
                "--device", torch.device(dev).type]))
        want = {"stem": TS_PREP_FRAMES, "scatter_max": TS_PREP_FRAMES,
                "swin_attn": 0, "swin_block": 0}
        if eval_launches != want:
            raise AssertionError(f"two-stage dist_test: launches "
                                 f"{eval_launches} != {want}")
        with open(os.path.join(root, "eval", "prediction.pkl"), "rb") as f:
            pred = pickle.load(f)
        cfg = load_config(cfg_path)
        det = build_detector(cfg["model"], None, cfg["test_cfg"], device=dev)
        det.module.load_state_dict(payload["state_dict"])
        ds = build_dataset(dict(cfg["data"]["val"]))
        n_same = 0
        for b in DataLoader(ds, 1, shuffle=False, max_points=EVAL_ROWS):
            o = det.predict(to_device({k: b[k] for k in ("points",
                                                         "points_mask")},
                                      dev))
            m_ = o["mask"][0]
            got = pred[b["metadata"][0]["token"]]
            for k in ("box3d_lidar", "scores", "label_preds"):
                if not np.array_equal(got[k], o[k][0][m_].cpu().numpy()):
                    raise AssertionError(f"two-stage dist_test {k} differs "
                                         "from a direct predict")
            n_same += 1
        keys = ["mAP/L1", "mAPH/L2"]
        if n_same != TS_PREP_FRAMES or not all(np.isfinite(metrics[k])
                                               for k in keys):
            raise AssertionError(f"two-stage dist_test: {n_same} frames, "
                                 f"{metrics}")
        log(f"two-stage dist_test on {card}: {n_same} frames, each bit-equal "
            f"to a direct predict; middle-third FPS {fps!r}; launches "
            f"{eval_launches}; " + ", ".join(f"{k} {metrics[k]!r}"
                                              for k in keys))
        res["dist_test"] = dict(fps=fps, launches=eval_launches)
    return res


def two_stage_phase(dev, card):
    """The frozen Waymo two-stage CenterPoint on the card at full width:
    its frame taking turns with the one-stage frame of the same first
    stage, the refine stage alone, a repeated frame, the two-sweep
    velocity frame, the frozen train step at batch 4, and the data prep,
    train CLI and dist_test of :func:`two_stage_prep_and_cli`."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.models.center_head import center_head_post_process
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    res = {}
    per_frame = {"stem": 1, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    m, train_cfg, tc = centerpoint_cfgs(TS_CONFIG)
    gen = torch.Generator().manual_seed(SEED + 11)
    t0 = time.perf_counter()
    det = build_detector(m, train_cfg, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    head = det.module.roi_head
    log(f"two-stage detector: grid {det.module.first.grid_size}, RoI head "
        f"{head.Dense_0.weight.shape[1]} -> {head.Dense_0.weight.shape[0]} "
        f"-> {head.Dense_1.weight.shape[0]}, "
        f"{sum(p.numel() for p in det.module.parameters())} params, frozen "
        f"first stage; built in {time.perf_counter() - t0:.1f} s")
    pr = m["first_stage_cfg"]["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_sweep(np.random.RandomState(SEED), pr, N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    # ---- the frame, taking turns with the one-stage frame (same weights)
    runs = {"two-stage": lambda: det.predict(ex),
            "one-stage": lambda: det.first_driver.predict(ex)}
    times = {k: [] for k in runs}
    tally = dict.fromkeys(per_frame, 0)
    for i in range(TS_FRAMES + 1):
        for name, run in runs.items():
            ms, out, counts = counted(run)
            if counts != per_frame:
                raise AssertionError(f"{name} frame {i}: launches {counts}")
            if i:
                times[name].append(ms)
                if name == "two-stage":
                    for k in tally:
                        tally[k] += counts[k]
    out = det.predict(ex)
    again = det.predict(ex)
    if not all(torch.equal(out[k], again[k]) for k in out):
        raise AssertionError("two-stage frame: a repeat differs")
    kept = check_detections(out, tc)
    busy = {name: device_busy(run) for name, run in runs.items()}
    with torch.no_grad():
        preds, bev = det.module(ex)
        boxes, scores = det.decode_proposals(preds["det_preds"][0])
        post = center_head_post_process(boxes, scores, det.test_cfg)
        props7 = torch.cat([post["box3d_lidar"][..., :6],
                            post["box3d_lidar"][..., -1:]], -1)
        refine = lambda: det.module.refine(bev, props7, post["scores"])
        refine_ms = device_ms(refine)
        refine_busy = device_busy(refine)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"two-stage frame on {card}: median {med['two-stage']!r} ms against "
        f"the one-stage frame's {med['one-stage']!r} on the same first stage, "
        f"taking turns over {TS_FRAMES} frames each (host clock around a "
        f"synchronized predict), all {times!r}; device busy and launches a "
        f"frame {busy!r} (torch.profiler, 3 frames); the refine stage "
        f"({tuple(bev.shape)} BEV, {props7.shape[1]} proposals x 5 points) "
        f"{refine_ms!r} ms device time (CUDA events), {refine_busy!r} "
        f"(busy ms, launches); kernel launches over {TS_FRAMES} frames "
        f"{tally}; {kept} boxes kept; a repeat bit-equal")
    res["frame"] = dict(median_ms=med["two-stage"],
                        one_stage_median_ms=med["one-stage"],
                        device_busy_ms=busy["two-stage"][0],
                        launches_per_frame=busy["two-stage"][1],
                        refine_ms=refine_ms, refine_launches=refine_busy[1],
                        launches=tally, kept=kept)
    del det, preds, bev, boxes, scores, post, out, again, runs
    torch.cuda.empty_cache()

    # ---- the two-sweep velocity frame: 8 features, the stem at C_in 11
    mv, _, tcv = centerpoint_cfgs(TS_VELO_CONFIG)
    gen = torch.Generator().manual_seed(SEED + 14)
    det = build_detector(mv, None, tcv, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    pts, mask = synthetic_sweep(np.random.RandomState(SEED + 14), pr,
                                2 * N_POINTS, c=8)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    median, times, out, tally = timed_predicts(det, ex, TS_VELO_FRAMES,
                                                   per_frame)
    kept = check_detections(out, tcv, box_dim=9)
    first = det.first_driver.predict(ex)
    if not (torch.equal(out["box3d_lidar"][..., 6:8],
                        first["box3d_lidar"][..., 6:8])
            and torch.equal(out["mask"], first["mask"])):
        raise AssertionError("two-sweep two-stage: velocity columns or kept "
                             "set differ from the first stage's")
    log(f"two-stage two-sweep frame on {card}: {2 * N_POINTS} points in "
        f"{pts.shape[1]} rows, 8 features (stem C_in 11): median {median!r} "
        f"ms over {TS_VELO_FRAMES} frames, all {times!r}; launches {tally}; "
        f"{kept} boxes kept, 9 columns, the velocity columns the first "
        "stage's")
    res["two_sweep"] = dict(median_ms=median, launches=tally, kept=kept)
    del det, out, first, ex
    torch.cuda.empty_cache()

    # ---- the frozen train step at the config's batch of 4
    from partner_tpu_torch.utils.config import load_config

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(SEED + 15)
    det = build_detector(m, train_cfg, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    batch = load_config(TS_CONFIG)["data"]["samples_per_gpu"]
    ex = centerpoint_train_example(
        np.random.RandomState(SEED + 15), m["first_stage_cfg"], train_cfg,
        batch, TRAIN_POINTS, TRAIN_ROWS, MAX_BOXES)
    ex = to_device({k: v for k, v in plant_positives(det, ex, dev).items()
                    if k in det.loss_keys}, dev)
    opt = build_one_cycle_optimizer(det.module, lr_max=3e-3,
                                    total_steps=1000)
    step = make_train_step(det, opt)
    before = {k: v.detach().clone() for k, v in
              det.module.state_dict().items()}
    want = {"stem": 1, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    times, launches = [], dict.fromkeys(want, 0)
    for i in range(TRAIN_STEPS + 1):
        ms, met, counts = counted(lambda: step(ex, None))
        if counts != want:
            raise AssertionError(f"frozen step {i}: launches {counts}")
        vals = {k: float(v) for k, v in met.items()}
        log(f"two-stage frozen step {i}: {ms!r} ms, {vals}")
        if not all(np.isfinite(list(vals.values()))) or not (
                vals["roi_reg_loss"] > 0):
            raise AssertionError(f"frozen step {i}: {vals}")
        if i:
            times.append(ms)
        for k in launches:
            launches[k] += counts[k]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = det.module.state_dict()
    moved_first = [k for k in after if k.startswith("first.")
                   and not torch.equal(after[k], before[k])]
    still_roi = [k for k in after if k.startswith("roi_head.")
                 and torch.equal(after[k], before[k])]
    if moved_first or still_roi or len(opt.params) != 12:
        raise AssertionError(f"frozen step: first stage moved {moved_first[:5]}"
                             f", RoI unchanged {still_roi}")
    median = statistics.median(times)
    log(f"two-stage frozen train step, batch {batch} ({TRAIN_POINTS} points "
        f"a sample in {TRAIN_ROWS} rows), on {card}: median {median!r} ms "
        f"over {TRAIN_STEPS} steps (host clock around a synchronized step), "
        f"all {times!r}; peak memory {peak!r} GiB; launches over "
        f"{TRAIN_STEPS + 1} steps {launches}; the first stage's parameters "
        "and statistics bit-unchanged, every RoI parameter moved")
    res["train"] = dict(median_ms=median, peak_gib=peak, launches=launches)
    del det, opt, step, ex, before, after
    torch.cuda.empty_cache()

    res.update(two_stage_prep_and_cli(dev, card, m, train_cfg, tc))
    return res


# ------------------------------------------------------------------ serving

SERVE_FRAMES = 8             # frames through each serving tool (cut first)
SERVE_ROWS = 200_000         # single_inference --max_points (its default)
MSI_ROWS = 432_000           # multi_sweep_inference --max_points: 2 sweeps
VOX_TOL = 1e-5               # dynamic voxel means, card against CPU


def identical(a, b):
    """Two detection dicts (tensors or numpy) equal bit for bit."""
    as_np = lambda x: x.cpu().numpy() if torch.is_tensor(x) else x
    return sorted(a) == sorted(b) and all(
        np.array_equal(as_np(a[k]), as_np(b[k])) for k in a)


def kept_boxes(out):
    """The kept boxes of sample 0 of a ``predict`` output, numpy."""
    m = out["mask"][0]
    return {k: out[k][0][m].cpu().numpy()
            for k in ("box3d_lidar", "scores", "label_preds")}


def cartesian_frames(rng, pc_range, n_frames):
    """SERVE_FRAMES-style synthetic sweeps: :func:`synthetic_scene`'s
    N_POINTS cartesian points with intensity and elongation, (N, 5)
    float32 each."""
    out = []
    for _ in range(n_frames):
        _, xyz = synthetic_scene(rng, pc_range, N_POINTS, MAX_BOXES)
        out.append(np.concatenate([xyz, rng.rand(len(xyz), 2)], 1).astype(
            np.float32))
    return out


def write_serving_config(root, config):
    """``config`` exec'd (its own path as ``__file__``, for the configs that
    read a sibling) with ``score_threshold`` 0, as :func:`frame_cfgs`."""
    path = os.path.join(root, "serving_" + os.path.basename(config))
    with open(path, "w") as f:
        f.write(f"__file__ = {config!r}\n"
                f"exec(open({config!r}).read())\n"
                "test_cfg['score_threshold'] = 0.0\n")
    return path


@torch.no_grad()
def voxel_reference(dev, card):
    """The voxel path against the CPU: ``dynamic_voxelize`` of the full
    180,000-point sweep on the card and on the CPU (coords, mask, counts
    equal; means within VOX_TOL (1 + |cpu|)), and the flagship backbone's
    voxel path on SMALL_GRID, the card (bf16, kernels) against the CPU
    (float32, plain twins) with the same weights, by relative RMS error
    (REF_BF16)."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.utils.config import load_config

    vg = load_config(CONFIG)["voxel_generator"]
    pts, mask = synthetic_sweep(np.random.RandomState(SEED + 12),
                                vg["range"], N_POINTS)
    got = DeviceVoxelizer(vg, dev, vg["max_voxel_num"])(
        torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
    want = DeviceVoxelizer(vg, "cpu", vg["max_voxel_num"])(
        torch.from_numpy(pts), torch.from_numpy(mask))
    for k in ("coords", "voxel_mask"):
        if not torch.equal(got[k].cpu(), want[k]):
            raise AssertionError(f"dynamic_voxelize {k}: card != CPU")
    err = (got["features"].cpu() - want["features"]).abs()
    n_bad = int((err > VOX_TOL * (1 + want["features"].abs())).sum())
    log(f"dynamic_voxelize on {card} against the CPU: "
        f"{int(want['voxel_mask'].sum())} voxels, coords and mask equal, "
        f"means max abs err {float(err.max())!r}, "
        f"{int((err != 0).sum())} of {err.numel()} not equal, {n_bad} beyond "
        f"{VOX_TOL} (1 + |cpu|)")
    if n_bad:
        raise AssertionError("dynamic_voxelize: card means beyond the bound")

    m, tc = frame_cfgs(grid=SMALL_GRID)
    gen = torch.Generator().manual_seed(SEED + 12)
    gpu = build_detector(m, None, tc, device=dev, generator=gen).module
    randomize_norms(gpu, gen)
    m32, _ = frame_cfgs(grid=SMALL_GRID, compute_dtype="float32")
    cpu = build_detector(m32, None, tc, device="cpu").module
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    vg_small = m["bbox_head"]["voxel_generator"]
    pts, mask = synthetic_sweep(np.random.RandomState(SEED + 12),
                                vg_small["range"], 30_000)
    vox = DeviceVoxelizer(vg_small, "cpu", 30_000)(torch.from_numpy(pts),
                                                    torch.from_numpy(mask))
    feats = cpu.reader(vox["features"])
    bev = cpu.backbone(feats, vox["coords"], vox["voxel_mask"], cpu.grid_size)
    on = {k: t.to(dev) for k, t in vox.items()}
    rel_rms(f"voxel-path backbone BEV on {card}", gpu.backbone(
        gpu.reader(on["features"]), on["coords"], on["voxel_mask"],
        gpu.grid_size), bev, REF_BF16)


def serving_phase(dev, card):
    """The voxel-input contract and the two serving tools on the card at
    full width:
    - the flagship frame through ``features`` (``dynamic_voxelize`` on the
      card, the reader, ``PolarDenseFHD.forward``), taking turns with the
      point-path frame on the same weights and sweep: median ms, device
      busy and launches a frame, the voxelizer's device time and launches,
      voxels found against the capacity, a repeated frame bit-equal;
    - :func:`voxel_reference`;
    - ``single_inference`` from a port checkpoint of those weights:
      ``run_frame`` over SERVE_FRAMES sweeps (detections and ms a frame,
      launches), each bit-equal to a direct ``predict`` of the same
      buffers, a repeated frame bit-equal, and ``--once`` over two frame
      files writing the same detections;
    - ``multi_sweep_inference --nsweeps 2`` with the two-sweep velocity
      CenterPoint config over SERVE_FRAMES timed frames with ego poses:
      launches, middle-third FPS, the last frame bit-equal to a direct
      ``predict`` of its two sweeps, and repeated."""
    import pickle
    import tempfile

    from partner_tpu_torch.core import box_np_ops
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops.voxelize import (DeviceVoxelizer,
                                                dynamic_voxelize)
    from partner_tpu_torch.tools import multi_sweep_inference as msi
    from partner_tpu_torch.tools import single_inference as si
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.utils.config import load_config

    res = {}
    vg = load_config(CONFIG)["voxel_generator"]
    cap = vg["max_voxel_num"]
    m, tc = frame_cfgs()
    pr = m["bbox_head"]["voxel_generator"]["range"]
    gen = torch.Generator().manual_seed(SEED + 11)
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    depth = det.module.bbox_head.layer.depth
    per_frame = {"stem": 1, "scatter_max": 1, "swin_attn": depth,
                 "swin_block": 0}
    pts, mask = synthetic_sweep(np.random.RandomState(SEED), pr, N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    vox = DeviceVoxelizer(vg, dev, cap)
    runs = {"voxel": lambda: det.predict(vox(ex["points"],
                                             ex["points_mask"])),
            "point": lambda: det.predict(ex)}
    times = {k: [] for k in runs}
    tally = {k: dict.fromkeys(per_frame, 0) for k in runs}
    outs = {}
    for i in range(FRAMES + 1):   # round 0 warms up; the paths take turns
        for k in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            ms, outs[k], counts = counted(runs[k])
            if counts != per_frame:
                raise AssertionError(f"{k} frame {i}: launches {counts} != "
                                     f"{per_frame}")
            if i:
                times[k].append(ms)
                for n in per_frame:
                    tally[k][n] += counts[n]
    again = runs["voxel"]()
    if not identical(again, outs["voxel"]):
        raise AssertionError("voxel frame: a repeated frame differs")
    kept = check_detections(outs["voxel"], tc)
    v = vox(ex["points"], ex["points_mask"])
    found = int(v["voxel_mask"].sum())
    fullest = int(dynamic_voxelize(
        ex["points"], ex["points_mask"], vox.voxel_size, vox.pc_range,
        vox.grid_size, cap)["num_points"].max())
    occupied = int(DeviceVoxelizer(vg, dev, pts.shape[1])(
        ex["points"], ex["points_mask"])["voxel_mask"].sum())
    busy, launches = device_busy(runs["voxel"])
    point_busy, point_launches = device_busy(runs["point"])
    vox_busy, vox_launches = device_busy(lambda: vox(ex["points"],
                                                     ex["points_mask"]))
    feats = det.module.reader(v["features"])
    with torch.no_grad():
        bb_busy, bb_launches = device_busy(lambda: det.module.backbone(
            feats, v["coords"], v["voxel_mask"], det.module.grid_size))
        pbb_busy, pbb_launches = device_busy(
            lambda: det.module.backbone.encode_points(
                ex["points"], ex["points_mask"], det.module.grid_size,
                det.module.pc_range))
    vox_ms = statistics.median(counted(lambda: vox(
        ex["points"], ex["points_mask"]))[0] for _ in range(5))
    medians = {k: statistics.median(t) for k, t in times.items()}
    log(f"voxel-path frame on {card}: {N_POINTS} points in {pts.shape[1]} "
        f"rows -> {found} voxels of a {cap} capacity ({occupied} cells "
        f"occupied, {found / cap!r} of the table full); median "
        f"{medians['voxel']!r} ms over {FRAMES} frames, all "
        f"{times['voxel']!r}; the point-path frame on the same weights, "
        f"taking turns: median {medians['point']!r} ms, all "
        f"{times['point']!r}; launches over {FRAMES} frames "
        f"{tally['voxel']}; {kept} boxes kept; a repeated frame bit-equal")
    log(f"voxel-path frame device busy {busy!r} ms and {launches!r} launches "
        f"a frame (point path {point_busy!r} ms, {point_launches!r}); "
        f"dynamic_voxelize {vox_busy!r} ms device and {vox_launches!r} "
        f"launches ({fullest} rows in the fullest voxel: one round of its "
        f"slot loop each), {vox_ms!r} ms host clock synchronized; the "
        f"backbone's voxel path {bb_busy!r} ms device and {bb_launches!r} "
        f"launches "
        f"(point path {pbb_busy!r} ms, {pbb_launches!r}) (torch.profiler, "
        "3 calls each)")
    res["voxel_frame"] = dict(
        median_ms=medians["voxel"], point_median_ms=medians["point"],
        device_busy_ms=busy, launches_per_frame=launches,
        point_device_busy_ms=point_busy, voxelize_device_ms=vox_busy,
        voxelize_launches=vox_launches, voxelize_ms=vox_ms,
        fullest_voxel=fullest,
        backbone_device_ms=bb_busy, point_backbone_device_ms=pbb_busy,
        voxels=found, occupied=occupied, capacity=cap, kept=kept,
        launches=tally["voxel"])
    del feats, v, outs, again

    voxel_reference(dev, card)

    with tempfile.TemporaryDirectory() as root:
        # ---- single_inference from a checkpoint of these weights
        save_checkpoint(os.path.join(root, "ckpt"), 0,
                        det.module.state_dict())
        ckpt = os.path.join(root, "ckpt", "latest")
        cfg_path = write_serving_config(root, CONFIG)
        del det
        torch.cuda.empty_cache()
        sdet, predict, meta = si.build_predictor(
            load_config(cfg_path), ckpt, SERVE_ROWS, device=dev)
        frames = cartesian_frames(np.random.RandomState(SEED + 13), pr,
                                  SERVE_FRAMES)
        svox = DeviceVoxelizer(vg, dev, cap)
        n_dets, ms, tally, saved = [], [], dict.fromkeys(per_frame, 0), []
        for i, cart in enumerate([frames[0]] + frames):  # one warm-up
            _, got, counts = counted(lambda: si.run_frame(predict, meta, cart,
                                                          0.0))
            if counts != per_frame:
                raise AssertionError(f"single_inference frame {i}: launches "
                                     f"{counts} != {per_frame}")
            feats = np.zeros((1, SERVE_ROWS, meta["n_feat"]), np.float32)
            fp = box_np_ops.transform_points(cart, "cylinder")[
                :, :meta["n_feat"]]
            feats[0, :len(fp)] = fp
            fmask = np.zeros((1, SERVE_ROWS), bool)
            fmask[0, :len(fp)] = True
            fex = to_device({"points": feats, "points_mask": fmask}, dev)
            direct = kept_boxes(sdet.predict(svox(fex["points"],
                                                  fex["points_mask"])))
            if not identical({k: got[k] for k in direct}, direct):
                raise AssertionError(f"single_inference frame {i}: differs "
                                     "from a direct predict")
            if i:
                saved.append(direct)
                n_dets.append(len(got["scores"]))
                ms.append(got["time"] * 1e3)
                for k in per_frame:
                    tally[k] += counts[k]
        again = si.run_frame(predict, meta, frames[-1], 0.0)
        if not identical({k: again[k] for k in direct}, direct):
            raise AssertionError("single_inference: a repeated frame differs")
        at_default = int((got["scores"] >= 0.3).sum())
        watch = os.path.join(root, "frames")
        os.makedirs(watch)
        for i in range(2):
            frames[i].tofile(os.path.join(watch, f"f{i}.bin"))
        del sdet, predict
        torch.cuda.empty_cache()
        _, _, once_launches = counted(lambda: si.main([
            cfg_path, "--once", "--watch_dir", watch, "--checkpoint", ckpt,
            "--score", "0.0", "--device", torch.device(dev).type]))
        for i in range(2):
            npz = np.load(os.path.join(watch, f"f{i}.det.npz"))
            if not identical(dict(npz), saved[i]):
                raise AssertionError(f"single_inference --once f{i}: its "
                                     ".det.npz differs from run_frame's")
        log(f"single_inference on {card}: {SERVE_FRAMES} frames of "
            f"{N_POINTS} points in {SERVE_ROWS} rows, ms a frame (the "
            f"tool's synchronized clock, copy in to outputs back) {ms!r}, "
            f"median {statistics.median(ms)!r}; detections a frame "
            f"(--score 0) {n_dets!r}, {at_default} of the last frame's at "
            f"the default --score 0.3; launches {tally}; every frame "
            f"bit-equal to a direct predict of the same buffers, a repeated "
            f"frame bit-equal; --once over 2 .bin files wrote the same "
            f"detections to their .det.npz (launches {once_launches})")
        res["single_inference"] = dict(median_ms=statistics.median(ms),
                                       ms=ms, detections=n_dets,
                                       launches=tally)

        # ---- multi_sweep_inference, the two-sweep velocity CenterPoint
        mv, _, tcv = centerpoint_cfgs(CP_VELO_CONFIG)
        gen = torch.Generator().manual_seed(SEED + 14)
        cdet = build_detector(mv, None, tcv, device=dev, generator=gen)
        randomize_norms(cdet.module, gen)
        save_checkpoint(os.path.join(root, "cp_ckpt"), 0,
                        cdet.module.state_dict())
        cp_cfg = write_serving_config(root, CP_VELO_CONFIG)
        rng = np.random.RandomState(SEED + 15)
        infos = []
        for i, cart in enumerate(cartesian_frames(rng, pr, SERVE_FRAMES)):
            pose = np.eye(4)
            yaw = 0.02 * i
            pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                            [np.sin(yaw), np.cos(yaw)]]
            pose[:3, 3] = [1.2 * i, 0.1 * i, 0.0]
            infos.append({"token": f"sweep_{i}", "points": cart,
                          "pose": pose, "timestamp": 1.0e6 + 0.1 * i})
        info_path = os.path.join(root, "sweeps.pkl")
        with open(info_path, "wb") as f:
            pickle.dump(infos[::-1], f)     # the tool sorts by timestamp
        cp_frame = {"stem": 1, "scatter_max": 1, "swin_attn": 0,
                    "swin_block": 0}
        _, (dets, fps), msi_launches = counted(lambda: msi.main([
            cp_cfg, "--info_path", info_path, "--checkpoint",
            os.path.join(root, "cp_ckpt", "latest"), "--nsweeps", "2",
            "--max_points", str(MSI_ROWS), "--work_dir",
            os.path.join(root, "msi"), "--device", torch.device(dev).type]))
        want = {k: n * SERVE_FRAMES for k, n in cp_frame.items()}
        if msi_launches != want:
            raise AssertionError(f"multi_sweep_inference: launches "
                                 f"{msi_launches} != {want}")
        kept = [(i["points"], i["pose"], i["timestamp"]) for i in infos[-2:]]
        fp = msi.frame_points(kept, infos[-1]["pose"], infos[-1]["timestamp"],
                              "cylinder", 8)
        feats = np.zeros((1, MSI_ROWS, 8), np.float32)
        feats[0, :len(fp)] = fp
        fmask = np.zeros((1, MSI_ROWS), bool)
        fmask[0, :len(fp)] = True
        fex = to_device({"points": feats, "points_mask": fmask}, dev)
        cp_vg = load_config(cp_cfg)["voxel_generator"]
        cvox = DeviceVoxelizer(cp_vg, dev, cp_vg["max_voxel_num"])
        direct = [kept_boxes(cdet.predict(cvox(fex["points"],
                                               fex["points_mask"])))
                  for _ in range(2)]
        last = dets[infos[-1]["token"]]
        if not (identical(last, direct[0]) and identical(direct[0],
                                                         direct[1])):
            raise AssertionError("multi_sweep_inference: the last frame "
                                 "differs from a direct predict")
        if last["box3d_lidar"].shape[1] != 9:
            raise AssertionError("multi_sweep_inference: boxes without "
                                 "velocity")
        n_dets = [len(d["scores"]) for d in dets.values()]
        log(f"multi_sweep_inference --nsweeps 2 on {card}: {SERVE_FRAMES} "
            f"frames of {N_POINTS} points, two sweeps ({len(fp)} points of "
            f"the last frame) in {MSI_ROWS} rows: middle-third FPS {fps!r}; "
            f"detections a frame {n_dets!r}; launches {msi_launches}; the "
            f"last frame bit-equal to a direct predict of its two sweeps, "
            f"and that predict repeated bit-equal")
        res["multi_sweep"] = dict(fps=fps, launches=msi_launches,
                                  detections=n_dets)
    return res


NATIVE_EDGE_M = 1e-4   # metres: how near a face a disagreement may lie


def rbbox_margin(points, boxes, pairs):
    """For (point, box) index pairs, the float64 distance of the point from
    the box's surface in the box frame (positive inside): the larger of
    the axes' |local| - half, negated."""
    p = points[pairs[:, 0], :3].astype(np.float64)
    b = boxes[pairs[:, 1]].astype(np.float64)
    d = p - b[:, :3]
    c, s = np.cos(b[:, -1]), np.sin(b[:, -1])
    local = np.stack([d[:, 0] * c + d[:, 1] * s, -d[:, 0] * s + d[:, 1] * c,
                      d[:, 2]], 1)
    return -np.max(np.abs(local) - b[:, 3:6] / 2, axis=1)


def collision_gap(corners, pairs):
    """For box index pairs, the float64 separating-axis gap in metres: the
    largest gap between the two boxes' projections over the 8 edge
    normals (positive where they are apart)."""
    a = corners[pairs[:, 0]].astype(np.float64)
    b = corners[pairs[:, 1]].astype(np.float64)
    gaps = []
    for box in (a, b):
        e = np.roll(box, -1, axis=1) - box
        n = np.stack([-e[..., 1], e[..., 0]], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        for k in range(4):
            pa = np.einsum("ni,npi->np", n[:, k], a)
            pb = np.einsum("ni,npi->np", n[:, k], b)
            gaps.append(np.maximum(pb.min(1) - pa.max(1),
                                   pa.min(1) - pb.max(1)))
    return np.max(gaps, axis=0)


def native_phase(card):
    """The native host library on the card's host: built and loaded (the
    run fails where it is not), its three functions against the numpy
    bodies at train sizes, and the host ms of each both ways. The hard
    voxelizer (a 180,000-point sweep at the flagship's voxel generator)
    must be bit-equal. The collision test (64 gt and 50-100 sampled boxes)
    and points in boxes (a sweep's points in its 32-64 boxes) compute in
    double where the numpy bodies compute in float32, so each
    disagreement, counted, must lie within NATIVE_EDGE_M of a box face (of
    touching) in float64."""
    from partner_tpu_torch import native
    from partner_tpu_torch.core import box_np_ops
    from partner_tpu_torch.data import augment
    from partner_tpu_torch.ops import voxelize
    from partner_tpu_torch.utils.config import load_config

    if not native.available():
        raise AssertionError("native: the library did not build or load")
    log(f"native library: {os.path.relpath(native.library_path(), ROOT)}")
    vg = load_config(CONFIG)["voxel_generator"]
    rng = np.random.RandomState(SEED + 16)
    pts, mask = synthetic_sweep(rng, vg["range"], N_POINTS)
    pts = pts[0][mask[0]]
    boxes, xyz = synthetic_scene(rng, vg["range"], N_POINTS, MAX_BOXES)
    boxes, xyz = boxes.astype(np.float32), xyz.astype(np.float32)
    more, _ = synthetic_scene(rng, vg["range"], 1000, 100)
    every = np.concatenate([boxes, more.astype(np.float32)])
    corners = box_np_ops.center_to_corner_box2d(
        every[:, :2], every[:, 3:5], every[:, 6]).astype(np.float32)
    gen = voxelize.VoxelGenerator(vg["voxel_size"], vg["range"],
                                  vg["max_points_in_voxel"],
                                  vg["max_voxel_num"])
    cases = {
        "points_to_voxel": lambda: gen.generate(pts),
        "box_collision_test": lambda: augment.box_collision_test(corners,
                                                                 corners),
        "points_in_rbbox": lambda: box_np_ops.points_in_rbbox(xyz, boxes),
    }
    out = {}
    for name, fn in cases.items():
        t0 = time.perf_counter()
        lib = fn()
        lib_ms = (time.perf_counter() - t0) * 1e3
        with native.numpy_only():
            t0 = time.perf_counter()
            body = fn()
            np_ms = (time.perf_counter() - t0) * 1e3
        if name == "points_to_voxel":
            differ = sum(int((a != b).sum()) if a.shape == b.shape else
                         max(a.size, b.size) for a, b in zip(lib, body))
            edge = 0.0
            size = sum(a.size for a in body)
        else:
            pairs = np.argwhere(lib != body)
            differ, size = len(pairs), body.size
            margin = (rbbox_margin(xyz, boxes, pairs)
                      if name == "points_in_rbbox"
                      else collision_gap(corners, pairs))
            edge = float(np.abs(margin).max()) if differ else 0.0
        log(f"native {name} on the card's host: {differ} of {size} outputs "
            f"differ from the numpy body (the farthest {edge!r} m from a "
            f"face); {lib_ms!r} ms with the library, {np_ms!r} ms without")
        if (name == "points_to_voxel" and differ) or edge > NATIVE_EDGE_M:
            raise AssertionError(f"native {name}: differs from numpy")
        out[name] = dict(ms=lib_ms, numpy_ms=np_ms, differ=differ)
    return out


# ------------------------------------------------- sparse / reference ckpt

SPARSE_EVAL_FRAMES = 9       # dist_test frames (cut first); window 3-5
SPARSE_BEV = 256             # the sparse backbone's BEV width (nz' 2 x 128)
# Sparse backbone on SMALL_GRID, card against CPU, both float32 (TF32 off):
# the same gathers and products summed in another order, through 6 stages
# of masked BatchNorm with randomized statistics. 2e-7-5e-7 on the CPU
# between 1 and 8 threads; bound 1e-5.
SPARSE_REF_TOL = 1e-5


def sparse_cfgs():
    """(model cfg, test cfg) of the flagship with ``model["backbone"]``
    replaced by the reference's ``SpMiddleResNetFHD`` (the neck takes its
    256-wide BEV), as :func:`frame_cfgs` otherwise."""
    m, tc = frame_cfgs()
    m["backbone"] = dict(type="SpMiddleResNetFHD", num_input_features=m[
        "backbone"]["num_input_features"])
    m["neck"]["num_input_features"] = SPARSE_BEV
    return m, tc


def sparse_maps(coords, mask, backbone, shape):
    """Every integer tensor the sparse backbone builds, with both index
    methods, stage by stage from sorted rows: the full-resolution
    submanifold map, then per strided stage the output coords and mask, the
    strided map and the next submanifold map."""
    from partner_tpu_torch.models import sparse as sp

    out = {"subm0": sp.build_subm_neighbor_map(coords, mask, shape),
           "subm0 dense": sp.build_subm_neighbor_map_dense(coords, mask,
                                                           shape)}
    for name in ("conv2", "conv3", "conv4", "extra_conv"):
        st = getattr(backbone, name)
        geom = (st.kernel, st.stride, st.padding)
        cap = coords.shape[1]
        oc, om = sp.downsample_coords(coords, mask, shape, *geom, cap)
        out_shape = sp.strided_out_shape(shape, *geom)
        out[f"{name} coords"], out[f"{name} mask"] = oc, om
        out[f"{name} coords dense"], out[f"{name} mask dense"] = (
            sp.downsample_coords_dense(coords, mask, shape, *geom, cap))
        out[f"{name} map"] = sp.build_strided_neighbor_map(
            oc, om, out_shape, coords, mask, shape, *geom)
        out[f"{name} map dense"] = sp.build_strided_neighbor_map_dense(
            oc, om, coords, mask, shape, *geom)
        if st.num_res:
            out[f"{name} subm"] = sp.build_subm_neighbor_map(oc, om,
                                                             out_shape)
            out[f"{name} subm dense"] = sp.build_subm_neighbor_map_dense(
                oc, om, out_shape)
        coords, mask, shape = oc, om, out_shape
    return out


def stage_sites(backbone, coords, mask, input_shape):
    """Per strided stage of the sparse backbone, (active sites with no
    capacity, sites kept at the input's N), from sorted rows."""
    from partner_tpu_torch.models import sparse as sp
    from partner_tpu_torch.models.backbone import sort_rows

    shape = backbone.sparse_shape(input_shape)
    _, coords, mask = sort_rows(coords, coords, mask, shape)
    n, out = coords.shape[1], {}
    for name in ("conv2", "conv3", "conv4", "extra_conv"):
        st = getattr(backbone, name)
        geom = (st.kernel, st.stride, st.padding)
        _, every = sp.downsample_coords(coords, mask, shape, *geom, 8 * n)
        coords, mask = sp.downsample_coords(coords, mask, shape, *geom, n)
        out[name] = (int(every.sum()), int(mask.sum()))
        shape = sp.strided_out_shape(shape, *geom)
    return out


@torch.no_grad()
def sparse_reference(dev, card):
    """The sparse backbone on SMALL_GRID, the card against the CPU, both in
    float32, on the voxels of a 30,000-point sweep: every neighbour map
    and out coords of both index methods exactly equal; the BEV within
    SPARSE_REF_TOL by relative RMS error; a sample's rows permuted giving
    a bit-equal BEV on the card."""
    import copy

    from partner_tpu_torch.models.backbone import (SpMiddleResNetFHD,
                                                   sort_rows)
    from partner_tpu_torch.models.layers import init_weights
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    m, _ = frame_cfgs(grid=SMALL_GRID)
    vg = m["bbox_head"]["voxel_generator"]
    pts, mask = synthetic_sweep(np.random.RandomState(SEED + 13),
                                vg["range"], 30_000)
    vox = DeviceVoxelizer(vg, "cpu", 30_000)(torch.from_numpy(pts),
                                              torch.from_numpy(mask))
    gen = torch.Generator().manual_seed(SEED + 13)
    cpu = SpMiddleResNetFHD(num_input_features=7, input_shape=SMALL_GRID)
    init_weights(cpu, gen)
    randomize_norms(cpu, gen)
    for name, p in cpu.named_parameters():
        if ".SparseConv_" in name and name.endswith(".bias"):
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    gpu = copy.deepcopy(cpu).to(dev).eval()
    cpu.eval()
    shape = cpu.sparse_shape(SMALL_GRID)
    maps = {}
    for d in ("cpu", dev):
        _, c, mk = sort_rows(vox["features"].to(d), vox["coords"].to(d),
                             vox["voxel_mask"].to(d), shape)
        maps[str(d)] = sparse_maps(c, mk, cpu if d == "cpu" else gpu, shape)
    n_int = 0
    for k, want in maps["cpu"].items():
        got = maps[str(dev)][k].cpu()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"sparse {k}: card != CPU")
        n_int += want.numel()
    sites = {k: int(maps["cpu"][k].sum()) for k in maps["cpu"]
             if k.endswith(" mask")}
    log(f"sparse maps on {card} against the CPU, SMALL_GRID {shape}: "
        f"{int(vox['voxel_mask'].sum())} voxels, active sites by stage "
        f"{sites}; all {len(maps['cpu'])} integer tensors ({n_int} values, "
        "both index methods) exactly equal")
    args = (vox["features"], vox["coords"], vox["voxel_mask"])
    want = cpu(*args, SMALL_GRID)
    got = gpu(*(a.to(dev) for a in args), SMALL_GRID)
    rel_rms(f"sparse backbone BEV on {card} (float32 both)", got, want,
            SPARSE_REF_TOL)
    perm = torch.randperm(args[0].shape[1], generator=gen)
    shuffled = gpu(*(a[:, perm].to(dev) for a in args), SMALL_GRID)
    if not torch.equal(shuffled, got):
        raise AssertionError("sparse backbone: permuted rows changed the BEV")
    log("sparse backbone: the rows permuted give a bit-equal BEV on the card")


def sparse_phase(dev, card):
    """The reference-layout PARTNER detector (the flagship with the sparse
    ``SpMiddleResNetFHD``) served from a det3d checkpoint at full width:
    - a seeded synthetic det3d checkpoint (``module.`` prefixes, spconv
      weights (kz, ky, kx, I, O) with the blocks' conv biases, every norm
      randomized) through ``tools.convert_checkpoint`` (neck and backbone;
      equal to the library's) and through
      ``torch_convert.convert_voxelnet_v3_state_dict`` (the whole detector,
      loaded strictly on the card);
    - ``predict`` on the 180,000-point sweep through ``dynamic_voxelize``
      at the config's 150,000 capacity, both head routes taking turns:
      median ms of FRAMES after a warm-up, launches (the attention kernel
      twice a frame on the per-block route, the block kernel twice on the
      whole-block route, stem and scatter-max never), device busy and
      launches a frame, a repeated frame bit-equal, finite maps, kept
      boxes; the backbone's ms by CUDA events; the phase's peak memory;
    - :func:`sparse_reference`;
    - ``dist_test --input voxels --checkpoint modelzoo://<name>`` (a zoo
      JSON in a temporary directory) over SPARSE_EVAL_FRAMES synthetic
      frames: launches, middle-third FPS, each frame bit-equal to a direct
      ``predict``."""
    import pickle
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import det3d_layout

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.tools import convert_checkpoint, dist_test
    from partner_tpu_torch.train import torch_convert
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from partner_tpu_torch.utils.config import load_config

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    res = {}
    m, tc = sparse_cfgs()
    neck = m["neck"]
    vg = m["bbox_head"]["voxel_generator"]
    cap = vg["max_voxel_num"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        sd = det3d_layout.partner_state_dict(
            np.random.RandomState(SEED + 14), m, SPARSE_BEV, "kzyxio")
        pth = os.path.join(root, "partner_sparse.pth")
        torch.save({"state_dict": sd, "meta": {"epoch": 36}}, pth)
        cli_dir = convert_checkpoint.main([
            pth, os.path.join(root, "cli"), "--layer_nums",
            *map(str, neck["layer_nums"]), "--us_strides",
            *map(str, neck["us_layer_strides"])])
        cli = load_checkpoint(cli_dir)[0]["state_dict"]
        whole = torch_convert.convert_voxelnet_v3_state_dict(
            sd, neck["layer_nums"], neck["us_layer_strides"])
        if not cli or any(not torch.equal(v, whole[k])
                          for k, v in cli.items()):
            raise AssertionError("convert_checkpoint: differs from the "
                                 "library's conversion")
        ckpt = save_checkpoint(os.path.join(root, "zoo"), 36, whole,
                               meta={"converted_from": pth})
        dets = {}
        for route, block in (("per_block", False), ("whole_block", True)):
            dets[route] = build_detector(m, None, tc, device=dev,
                                         use_block_kernel=block)
            dets[route].module.load_state_dict(whole, strict=True)
            if dets[route].input_kind != "voxels":
                raise AssertionError("sparse detector: input_kind")
        log(f"sparse PARTNER: synthetic det3d checkpoint of {len(sd)} "
            f"tensors ({sum(v.numel() for v in sd.values())} values), the "
            f"CLI's {len(cli)} neck and backbone tensors equal to the "
            f"library's, the whole detector ({len(whole)} tensors) loaded "
            f"strictly on both routes in {time.perf_counter() - t0:.1f} s")

        pts, mask = synthetic_sweep(np.random.RandomState(SEED), vg["range"],
                                    N_POINTS)
        ex = to_device({"points": pts, "points_mask": mask}, dev)
        vox = DeviceVoxelizer(vg, dev, cap)
        depth = dets["per_block"].module.bbox_head.layer.depth
        want = {"per_block": {"stem": 0, "scatter_max": 0,
                              "swin_attn": depth, "swin_block": 0},
                "whole_block": {"stem": 0, "scatter_max": 0,
                                "swin_attn": 0, "swin_block": depth}}
        runs = {r: (lambda d=d: d.predict(vox(ex["points"],
                                              ex["points_mask"])))
                for r, d in dets.items()}
        times = {r: [] for r in runs}
        tally = {r: dict.fromkeys(want[r], 0) for r in runs}
        outs = {}
        for i in range(FRAMES + 1):   # round 0 warms up; routes take turns
            for r in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                ms, outs[r], counts = counted(runs[r])
                if counts != want[r]:
                    raise AssertionError(f"sparse {r} frame {i}: launches "
                                         f"{counts} != {want[r]}")
                if i:
                    times[r].append(ms)
                    for k in counts:
                        tally[r][k] += counts[k]
        for r in runs:
            if not identical(runs[r](), outs[r]):
                raise AssertionError(f"sparse {r}: a repeated frame differs")
            kept = check_detections(outs[r], tc)
        v = vox(ex["points"], ex["points_mask"])
        with torch.no_grad():
            maps = dets["per_block"].module(v)
            if not all(torch.isfinite(x).all() for x in maps.values()):
                raise AssertionError("sparse frame: non-finite maps")
            feats = dets["per_block"].module.reader(v["features"])
            grid = dets["per_block"].module.grid_size
            backbone = dets["per_block"].module.backbone
            bb = call_and_device_ms("ms", lambda: backbone(
                feats, v["coords"], v["voxel_mask"], grid))
            bev = backbone(feats, v["coords"], v["voxel_mask"], grid)
            bb_busy, bb_launches = device_busy(lambda: backbone(
                feats, v["coords"], v["voxel_mask"], grid))
            sites = stage_sites(backbone, v["coords"], v["voxel_mask"],
                                grid)
        busy, launches = device_busy(runs["per_block"])
        medians = {r: statistics.median(t) for r, t in times.items()}
        found = int(v["voxel_mask"].sum())
        log(f"sparse backbone stages at full width: active sites uncapped / "
            f"kept at the {cap} capacity {sites}")
        log(f"sparse PARTNER frame on {card}: {N_POINTS} points -> {found} "
            f"voxels of {cap}; median ms per block {medians['per_block']!r},"
            f" whole block {medians['whole_block']!r} over {FRAMES} frames "
            f"taking turns, all {times!r}; launches over {FRAMES} frames "
            f"{tally}; {kept} boxes kept; repeats bit-equal; BEV "
            f"{tuple(bev.shape)}, maps finite")
        log(f"sparse frame device busy {busy!r} ms and {launches!r} launches "
            f"a frame (per block); the backbone {bb['ms']!r} ms a call by "
            f"CUDA events ({bb['device_ms']!r} device ms back to back), "
            f"{bb_busy!r} ms of kernels in {bb_launches!r} launches")
        res["frame"] = dict(median_ms=medians, launches=tally,
                            device_busy_ms=busy, launches_per_frame=launches,
                            backbone_ms=bb["ms"],
                            backbone_device_ms=bb["device_ms"],
                            backbone_busy_ms=bb_busy,
                            backbone_launches=bb_launches, voxels=found,
                            kept=kept, sites=sites)
        del maps, feats, bev, v

        sparse_reference(dev, card)

        info_path = write_val_set(root, np.random.RandomState(SEED + 15),
                                  vg["range"], SPARSE_EVAL_FRAMES)
        cfg_path = write_eval_config(root, info_path)
        with open(cfg_path, "a") as f:
            f.write(f"model['backbone'] = {m['backbone']!r}\n"
                    f"model['neck']['num_input_features'] = {SPARSE_BEV}\n")
        zoo = os.path.join(root, "model_zoo.json")
        with open(zoo, "w") as f:
            json.dump({"partner_sparse_synthetic": ckpt}, f)
        env = {k: os.environ.get(k) for k in ("PARTNER_TPU_MODEL_ZOO",
                                              "PARTNER_TPU_CACHE")}
        os.environ["PARTNER_TPU_MODEL_ZOO"] = zoo
        os.environ["PARTNER_TPU_CACHE"] = os.path.join(root, "cache")
        work_dir = os.path.join(root, "eval")
        try:
            _, ((metrics, _), fps), dist_launches = counted(
                lambda: dist_test.main([
                    cfg_path, "--input", "voxels", "--checkpoint",
                    "modelzoo://partner_sparse_synthetic", "--work_dir",
                    work_dir, "--max_points", str(EVAL_ROWS), "--device",
                    torch.device(dev).type]))
        finally:
            for k, val in env.items():
                if val is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = val
        with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
            preds = pickle.load(f)
        ds = build_dataset(dict(load_config(cfg_path)["data"]["val"]))
        direct = {}
        for b in DataLoader(ds, 1, shuffle=False, max_points=EVAL_ROWS):
            e = to_device({k: b[k] for k in ("points", "points_mask")}, dev)
            direct[b["metadata"][0]["token"]] = kept_boxes(
                dets["per_block"].predict(vox(e["points"],
                                              e["points_mask"])))
    want_dist = {"stem": 0, "scatter_max": 0,
                 "swin_attn": depth * SPARSE_EVAL_FRAMES, "swin_block": 0}
    if dist_launches != want_dist:
        raise AssertionError(f"sparse dist_test: launches {dist_launches} "
                             f"!= {want_dist}")
    if sorted(preds) != sorted(direct) or not all(
            np.array_equal(preds[t][k], direct[t][k])
            for t in direct for k in direct[t]):
        raise AssertionError("sparse dist_test: a frame differs from a "
                             "direct predict")
    if not all(np.isfinite(metrics[k]) for k in ("mAP/L1", "mAPH/L2")):
        raise AssertionError("sparse dist_test: metrics not finite")
    res["dist_test"] = dict(fps=fps, launches=dist_launches)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"sparse dist_test --input voxels --checkpoint modelzoo://... on "
        f"{card}: middle-third FPS {fps!r} over {SPARSE_EVAL_FRAMES} frames,"
        f" launches {dist_launches}, every frame bit-equal to a direct "
        f"predict; mAP/L1 {metrics['mAP/L1']!r}")
    log(f"sparse phase: peak memory {res['peak_gib']!r} GiB, "
        f"{time.perf_counter() - t_phase:.1f} s in all")
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this run needs one NVIDIA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full-f32 products wherever a reference computes in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from partner_tpu_torch.ops import _cuda

    card = gpu_name_and_power_limit()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    lib = _cuda.library()
    log(f"nvcc build of partner_tpu_torch/csrc: {lib.build_seconds!r} s "
        f"-> {os.path.relpath(lib.so_path, ROOT)}")
    for line in lib.ptxas_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log("  ptxas:", line.strip())

    gen = torch.Generator().manual_seed(SEED)
    kres = kernel_phase(gen, dev, card)
    routes = frame_phase(dev, card)
    train_launches, train_ms, train_peak = train_phase(dev, card)
    reference_phase(dev)
    train_reference_phase(dev)
    eval_launches, eval_fps, eval_beyond, eval_clocks, eval_quiet = (
        eval_phase(dev, card))
    static = static_rpe_phase(dev, card)
    cli = train_cli_phase(dev, card)
    cp = centerpoint_phase(dev, card)
    ts = two_stage_phase(dev, card)
    serving = serving_phase(dev, card)
    nat = native_phase(card)
    sparse = sparse_phase(dev, card)

    meta = {
        "stem": ("partner_tpu_torch/csrc/stem.cu",
                 "partner_tpu/ops/stem_pallas.py:79", "per_block"),
        "scatter_max": ("partner_tpu_torch/csrc/scatter_max.cu",
                        "tools/probes/pallas_scatter_stripe.py:101",
                        "per_block"),
        "swin_attn": ("partner_tpu_torch/csrc/swin_attn.cu",
                      "partner_tpu/ops/swin_attn_pallas.py:137", "per_block"),
        "swin_block": ("partner_tpu_torch/csrc/swin_block.cu",
                       "partner_tpu/ops/swin_block_pallas.py:253",
                       "whole_block"),
    }
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1],
                    launches=routes[meta[name][2]][0][name],
                    train_launches=train_launches[name],
                    eval_launches=eval_launches[name],
                    static_rpe_launches=static["cached"]["launches"][name],
                    train_cli_launches=cli["launches"][name],
                    centerpoint_launches=cp["frame"]["launches"][name],
                    centerpoint_two_sweep_launches=cp["two_sweep"][
                        "launches"][name],
                    centerpoint_train_launches=cp["train"]["launches"][name],
                    centerpoint_dist_test_launches=cp["dist_test"][
                        "launches"][name],
                    centerpoint_train_cli_launches=cp["train_cli"][
                        "launches"][name],
                    two_stage_launches=ts["frame"]["launches"][name],
                    two_stage_two_sweep_launches=ts["two_sweep"][
                        "launches"][name],
                    two_stage_frozen_train_launches=ts["train"]["launches"][
                        name],
                    two_stage_train_cli_launches=ts["train_cli"]["launches"][
                        name],
                    two_stage_dist_test_launches=ts["dist_test"][
                        "launches"][name],
                    voxel_frame_launches=serving["voxel_frame"]["launches"][
                        name],
                    single_inference_launches=serving["single_inference"][
                        "launches"][name],
                    multi_sweep_launches=serving["multi_sweep"]["launches"][
                        name],
                    sparse_frame_launches=sparse["frame"]["launches"][
                        meta[name][2]][name],
                    sparse_dist_test_launches=sparse["dist_test"]["launches"][
                        name],
                    **r)
               for name, r in kres.items()]
    log("summary: card " + card + ", flagship frame median ms: " + ", ".join(
        f"{route} {ms!r}" for route, (_, ms) in routes.items())
        + f"; flagship train step median ms {train_ms!r}, peak "
        f"{train_peak!r} GiB; dist_test middle-third FPS {eval_fps!r} over "
        f"{EVAL_FRAMES} frames, host {eval_beyond!r} ms a frame beyond "
        f"predict, predict with no loader thread beside it {eval_quiet!r} "
        f"ms, SM MHz / W by third {eval_clocks}; static RPE cached / "
        f"live frame median {static['cached']['median_ms']!r} / "
        f"{static['live']['median_ms']!r} ms, device busy "
        f"{static['cached']['device_busy_ms']!r} / "
        f"{static['live']['device_busy_ms']!r} ms, cache "
        f"{static['cache_bytes']} bytes; train CLI median step "
        f"{cli['median_s']!r} s, data share {cli['data_share']!r}, host "
        f"{cli['sample_ms']!r} ms a sample, loader {cli['loader_rate']!r} "
        f"batches a second, GT-AUG {cli['inserted']!r} boxes a sample, peak "
        f"{cli['peak']!r} GiB")
    log(f"summary: card {card}, CenterPoint frame median "
        f"{cp['frame']['median_ms']!r} ms, device busy "
        f"{cp['frame']['device_busy_ms']!r} ms and "
        f"{cp['frame']['launches_per_frame']!r} launches a frame, "
        f"{cp['frame']['kept']} boxes kept; two-sweep frame median "
        f"{cp['two_sweep']['median_ms']!r} ms; train step median "
        f"{cp['train']['median_ms']!r} ms, peak {cp['train']['peak_gib']!r} "
        f"GiB; dist_test middle-third FPS {cp['dist_test']['fps']!r}; train "
        f"CLI 2 steps in {cp['train_cli']['wall_s']!r} s; stem C_in 11 "
        f"device {kres['stem']['device_ms_cin11']!r} ms, bound "
        f"{kres['stem']['bound_ms_cin11']!r} ms, share "
        f"{kres['stem']['bound_share_cin11']!r}; scatter-max at 432,000 rows "
        f"device {kres['scatter_max']['device_ms_p432000']!r} ms, bound "
        f"{kres['scatter_max']['bound_ms_p432000']!r} ms, share "
        f"{kres['scatter_max']['bound_share_p432000']!r}, "
        f"{kres['scatter_max']['not_equal_p432000']} not equal to the twin")
    st, sm = kres["stem"], kres["scatter_max"]
    log(f"summary: card {card}, at a train step's batch of 4: stem (4, 10, "
        f"180000) device {st['device_ms_b4']!r} ms, bound "
        f"{st['bound_ms_b4']!r} ms, share {st['bound_share_b4']!r}, "
        f"{st['not_equal_b4']} not equal to the twin; scatter-max device "
        f"{sm['device_ms_b4']!r} ms, bound {sm['bound_ms_b4']!r} ms, share "
        f"{sm['bound_share_b4']!r}, {sm['not_equal_b4']} not equal to the "
        "twin")
    tf = ts["frame"]
    log(f"summary: card {card}, two-stage frame median {tf['median_ms']!r} "
        f"ms against the one-stage {tf['one_stage_median_ms']!r} taking "
        f"turns, device busy {tf['device_busy_ms']!r} ms and "
        f"{tf['launches_per_frame']!r} launches a frame, refine "
        f"{tf['refine_ms']!r} ms device in {tf['refine_launches']!r} "
        f"launches, {tf['kept']} boxes kept; two-sweep frame median "
        f"{ts['two_sweep']['median_ms']!r} ms; frozen train step median "
        f"{ts['train']['median_ms']!r} ms, peak {ts['train']['peak_gib']!r} "
        f"GiB; data prep ms a frame {ts['prep_ms']!r}; train CLI 2 steps "
        f"in {ts['train_cli']['wall_s']!r} s; dist_test middle-third FPS "
        f"{ts['dist_test']['fps']!r}")
    vf, sm, st = serving["voxel_frame"], kres["scatter_max"], kres["stem"]
    log(f"summary: card {card}, voxel-path frame median "
        f"{vf['median_ms']!r} ms (point path {vf['point_median_ms']!r} ms, "
        f"taking turns), device busy {vf['device_busy_ms']!r} ms and "
        f"{vf['launches_per_frame']!r} launches a frame, dynamic_voxelize "
        f"{vf['voxelize_device_ms']!r} ms device and "
        f"{vf['voxelize_launches']!r} launches, {vf['voxels']} voxels of "
        f"{vf['capacity']}; single_inference median "
        f"{serving['single_inference']['median_ms']!r} ms a frame, "
        f"{serving['single_inference']['detections']} detections; "
        f"multi_sweep_inference middle-third FPS "
        f"{serving['multi_sweep']['fps']!r}; stem at the voxel rows device "
        f"{st['device_ms_voxel']!r} ms (bound {st['bound_ms_voxel']!r}), "
        f"C_in 11 {st['device_ms_voxel_cin11']!r} ms (bound "
        f"{st['bound_ms_voxel_cin11']!r}); scatter-max at the voxel rows "
        f"{sm['device_ms_voxel']!r} ms (bound {sm['bound_ms_voxel']!r}), "
        f"{sm['not_equal_voxel']} not equal to the twin; native "
        f"{ {k: (v['ms'], v['numpy_ms']) for k, v in nat.items()} } ms "
        f"(library, numpy); train host path {cli['sample_ms_lib']!r} ms a "
        f"sample with the library, {cli['sample_ms_numpy']!r} without "
        f"(in turns); "
        f"loader {cli['loader_rate']!r} / {cli['loader_rate_numpy']!r} "
        f"batches a second")
    sf = sparse["frame"]
    log(f"summary: card {card}, sparse PARTNER (SpMiddleResNetFHD from a "
        f"converted det3d checkpoint) frame median per block "
        f"{sf['median_ms']['per_block']!r} ms, whole block "
        f"{sf['median_ms']['whole_block']!r} ms, device busy "
        f"{sf['device_busy_ms']!r} ms and {sf['launches_per_frame']!r} "
        f"launches a frame, backbone {sf['backbone_ms']!r} ms "
        f"({sf['backbone_device_ms']!r} device), {sf['voxels']} voxels, "
        f"{sf['kept']} boxes kept; peak {sparse['peak_gib']!r} GiB; "
        f"dist_test from modelzoo:// middle-third FPS "
        f"{sparse['dist_test']['fps']!r}; block kernel at more draws "
        f"{kres['swin_block']['more_draws']}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
