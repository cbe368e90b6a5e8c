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
   its canvas fill alone;
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
   as frame pickles, with GT-AUG from a database cut from them (the
   flagship's Vehicle=15 quota, its filters and augmentations): 4 steps
   in 2 epochs with a checkpoint and a validation after each, then a run
   to step 6 that resumes from ``latest`` at step 4 with the checkpoint's
   Adam count and moments. Readings: each step's loss terms, gradient
   norm and phase times (finite), the median step time and the data share,
   GT-AUG boxes inserted per sample, peak memory, each validation's
   metrics, the kernels' launches per train step and per validation frame,
   and the host data path alone (ms a sample in one thread, the loader's
   batches a second with its threads).

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


def not_equal(name, out, ref):
    """{"not_equal": elements of ``out`` whose value differs from ``ref``,
    "elements": their number}: a kernel that sums in another order than its
    twin can flip a bf16 rounding within the bound."""
    n = int((out.float() != ref.float()).sum())
    log(f"{name}: {n} of {out.numel()} elements not equal to the twin")
    return {"not_equal": n, "elements": out.numel()}


# ------------------------------------------------------------------ kernels

def stem_case(gen, dev):
    """Stem inputs at the flagship shape: (1, 10, 216,000) bf16."""
    from partner_tpu_torch.ops import stem

    p = int(N_POINTS * 1.2)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen)
    x = rnd(1, stem.CIN, p).to(bf)
    mask = torch.rand(1, p, generator=gen) < N_POINTS / p
    w1 = (rnd(stem.F1, stem.CIN) * stem.CIN ** -0.5).to(bf)
    w2 = (rnd(stem.F2, stem.F1) * stem.F1 ** -0.5).to(bf)
    a1, a2 = (0.5 + torch.rand(f, generator=gen) for f in (stem.F1, stem.F2))
    b1, b2 = (0.2 * rnd(f) for f in (stem.F1, stem.F2))
    return [t.to(dev) for t in (x, mask, w1, a1, b1, w2, a2, b2)]


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


def scatter_case(stem_out, dev):
    """Scatter-max inputs at the flagship shape: the stem's (1, 64,
    216,000) output and the canvas coords of a synthetic sweep on the
    flagship grid (rows past the sweep and out of range masked)."""
    grid, pr, _ = flagship_grid()
    n_r, n_az, n_z = grid
    canvas = (n_z // 8, n_az // 4, n_r // 4)                # (cz, cy, cx)
    pts, mask = synthetic_sweep(np.random.RandomState(SEED), pr, N_POINTS)
    cell = np.asarray([(pr[3] - pr[0]) / n_r * 4, (pr[4] - pr[1]) / n_az * 4,
                       (pr[5] - pr[2]) / n_z * 8], np.float32)
    idx = np.floor((pts[0, :, :3] - np.asarray(pr[:3], np.float32)) / cell)
    idx = idx.astype(np.int32)                              # (P, 3) r, az, z
    inb = mask[0] & np.all((idx >= 0) & (idx < np.asarray(canvas[::-1])), 1)
    coords = np.ascontiguousarray(idx[:, ::-1].T)[None]     # (1, 3, P) z, az, r
    return (stem_out, torch.from_numpy(coords).to(dev),
            torch.from_numpy(inb[None]).to(dev), canvas)


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


def timed(name, args, kernel, plain, library=None):
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
    log(f"{name}: kernel {r['ms']!r} ms a call ({r['device_ms']!r} device), "
        f"plain {r['plain_ms']!r} ({r['plain_device_ms']!r}), library "
        f"{r['library_ms']!r} ({r['library_device_ms']!r}); bound "
        f"{bound_ms!r} ms by {bound_by}, {r['bound_share']!r} of it reached")
    return r


def kernel_phase(gen, dev):
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
    # the wrapper's zero fill of the canvas alone, in each dtype
    b, c, _ = sargs[0].shape
    for tag, dt in (("", torch.bfloat16), ("_f32", torch.float32)):
        results["scatter_max"].update(call_and_device_ms(
            f"zero_ms{tag}", lambda: torch.zeros(
                (b, int(np.prod(sargs[3])), c), dtype=dt, device=dev)))

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
            "ms", "device_ms", "plain_ms", "plain_device_ms")})

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
    return {k: torch.from_numpy(v).to(dev) for k, v in example.items()}


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
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            outs[route] = dets[route].predict(ex)
            torch.cuda.synchronize()
            if i:
                times[route].append((time.perf_counter() - t0) * 1e3)
            for name, fn in wrappers.items():
                tally[route][name] += fn.launches
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


def check_detections(out, tc):
    post = tc["nms"]["nms_post_max_size"]
    shapes = {"box3d_lidar": (1, post, 7), "scores": (1, post),
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


def train_phase(dev, card):
    """The flagship train step at full width and the config's batch:
    launch counts per step, step times, peak memory, finite losses and
    gradients, and parameters and BatchNorm statistics that moved."""
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
    before = {k: v.detach().clone() for k, v in det.module.state_dict().items()}
    wrappers = kernel_wrappers()
    drops = torch.Generator().manual_seed(SEED + 3)  # dropout and DropPath
    times, launches = [], dict.fromkeys(wrappers, 0)
    for i in range(TRAIN_STEPS + 1):   # step 0 warms up
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        met = step(ex, drops)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i:
            times.append(ms)
        counts = {name: fn.launches for name, fn in wrappers.items()}
        want = {"stem": 0, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
        if counts != want:
            raise AssertionError(f"train step {i}: launches {counts} != {want}")
        for name in launches:
            launches[name] += counts[name]
        vals = {k: float(v) for k, v in met.items()}
        log(f"train step {i}: {ms!r} ms, " + ", ".join(
            f"{k} {v!r}" for k, v in sorted(vals.items())))
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: non-finite metrics")
        if not vals["grad_norm"] > 0 or not vals["num_matched"] > 0:
            raise AssertionError(f"train step {i}: no gradient or no match")
    for name, p in det.module.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"train: gradient of {name} missing or "
                                 "non-finite")
    after = det.module.state_dict()
    watched = [k for k, _ in det.module.named_parameters()] + [
        k for k in before if k.endswith(("_mean", "_var"))]
    still = [k for k in watched if torch.equal(before[k], after[k])]
    if still:
        raise AssertionError(f"train: unchanged after the steps: {still[:5]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    median = statistics.median(times)
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

def write_val_set(root, rng, pc_range, n_frames):
    """A synthetic Waymo val info pkl under ``root``: per frame a
    :func:`synthetic_scene` of N_POINTS points as raw [x, y, z, intensity,
    elongation] rows (the pipeline's ``transform_points`` adds rho, phi),
    its boxes as vehicle gts [x, y, z, dx, dy, dz, vx, vy, yaw]."""
    import pickle

    infos = []
    for i in range(n_frames):
        boxes, xyz = synthetic_scene(rng, pc_range, N_POINTS, MAX_BOXES)
        gt = np.zeros((len(boxes), 9), np.float32)
        gt[:, :6], gt[:, 8] = boxes[:, :6], boxes[:, 6]
        pts = np.concatenate([xyz, rng.rand(len(xyz), 2)], 1)
        infos.append({"token": f"frame_{i}", "points": pts.astype(np.float32),
                      "gt_boxes": gt, "gt_names": np.array(["Vehicle"] * len(gt))})
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
        wrappers = kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        E2EDetector.predict = timed_predict
        try:
            t0 = time.perf_counter()
            ((metrics, _), fps), clocks = sample_clocks(
                lambda: dist_test.main([
                    cfg_path, "--checkpoint",
                    os.path.join(root, "ckpt", "latest"),
                    "--work_dir", work_dir, "--max_points", str(EVAL_ROWS),
                    "--device", torch.device(dev).type]))
            wall_s = time.perf_counter() - t0
        finally:
            E2EDetector.predict = predict
        launches = {name: fn.launches for name, fn in wrappers.items()}
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
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            outs[mode] = det.predict(ex)
            torch.cuda.synchronize()
            if i:
                times[mode].append((time.perf_counter() - t0) * 1e3)
            for name, fn in wrappers.items():
                tally[mode][name] += fn.launches
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
    """A synthetic Waymo train set under ``root``: per frame a
    :func:`synthetic_scene` of TRAIN_POINTS points written as a Waymo frame
    pickle (``lidars.points_xyz`` and ``points_feature``), the even frames
    with 32-64 vehicle boxes (above the flagship's GT-AUG quota of 15, so
    nothing is inserted), the odd ones with 6-12 (GT-AUG tops them up); and
    its info pkl (path, 9-column gt boxes, names)."""
    import pickle

    os.makedirs(os.path.join(root, "lidar"))
    infos = []
    for i in range(n_frames):
        boxes, xyz = synthetic_scene(
            rng, pc_range, TRAIN_POINTS,
            MAX_BOXES if i % 2 == 0 else TRAIN_CLI_SPARSE_BOXES)
        gt = np.zeros((len(boxes), 9), np.float32)
        gt[:, :6], gt[:, 8] = boxes[:, :6], boxes[:, 6]
        path = os.path.join(root, "lidar", f"frame_{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"lidars": {
                "points_xyz": xyz.astype(np.float32),
                "points_feature": rng.rand(len(xyz), 2).astype(np.float32)}},
                f)
        infos.append({"token": f"train_{i}", "path": path, "gt_boxes": gt,
                      "gt_names": np.array(["Vehicle"] * len(gt))})
    info_path = os.path.join(root, "infos_train.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path


def write_gt_database(root, info_path):
    """The GT database of ``tools/create_data.py:create_groundtruth_database``
    cut from the train frames with the port's ``points_in_rbbox``: per box
    its points shifted to the box center, as float32 (n, 5) files, and a
    dbinfos pkl with ``num_points_in_gt`` and difficulty 0 -> (its path,
    objects written)."""
    import pickle

    from partner_tpu_torch.core.box_np_ops import points_in_rbbox
    from partner_tpu_torch.data.pipeline import get_obj, read_single_waymo

    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    os.makedirs(os.path.join(root, "gt_database"))
    db, count = {}, 0
    for info in infos:
        points = read_single_waymo(get_obj(info["path"])).astype(np.float32)
        b7 = np.concatenate([info["gt_boxes"][:, :6],
                             info["gt_boxes"][:, -1:]], 1)
        inside = points_in_rbbox(points[:, :3], b7)
        for i, name in enumerate(info["gt_names"]):
            obj = points[inside[:, i]].copy()
            obj[:, :3] -= b7[i, :3]
            rel = os.path.join("gt_database", f"{name}_{count}.bin")
            obj.tofile(os.path.join(root, rel))
            db.setdefault(str(name), []).append({
                "name": str(name), "path": rel,
                "box3d_lidar": info["gt_boxes"][i],
                "num_points_in_gt": int(inside[:, i].sum()), "difficulty": 0})
            count += 1
    path = os.path.join(root, "dbinfos_train.pkl")
    with open(path, "wb") as f:
        pickle.dump(db, f)
    return path, count


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
        train_info = write_train_set(root, rng, pc_range, TRAIN_CLI_FRAMES)
        db_info, n_objects = write_gt_database(root, train_info)
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
            for fn in wrappers.values():
                fn.launches = 0
            walls = []
            for total in (4, 6):
                t0 = time.perf_counter()
                if train.main(common + ["--total_steps", str(total)]) != total:
                    raise AssertionError(f"train CLI: did not reach {total}")
                walls.append(time.perf_counter() - t0)
            launches = {k: fn.launches for k, fn in wrappers.items()}
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
    return dict(launches=launches, median_s=median, data_share=data_share,
                inserted=statistics.mean(inserted), peak=peak, walls=walls,
                sample_ms=statistics.median(sample_ms), loader_rate=rate)


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
    kres = kernel_phase(gen, dev)
    routes = frame_phase(dev, card)
    train_launches, train_ms, train_peak = train_phase(dev, card)
    reference_phase(dev)
    train_reference_phase(dev)
    eval_launches, eval_fps, eval_beyond, eval_clocks, eval_quiet = (
        eval_phase(dev, card))
    static = static_rpe_phase(dev, card)
    cli = train_cli_phase(dev, card)

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
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
