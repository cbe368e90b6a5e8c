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
14. nuScenes: the three nuScenes CenterPoint configs
   (``configs/nusc/voxelnet/nusc_centerpoint_voxelnet_{dcn,01voxel,
   dcn_flip}.py``: six tasks, the DCN heads on the plain deformable conv,
   the flip config's four copies a sample) at full width, random weights
   with norms and offset convs randomized, on a synthetic 10-sweep set of
   ~34,000-point sweeps written as nuScenes files and prepared by the
   port's ``create_data nuscenes_data_prep``: each config's frame (median
   ms, device busy and launches, kept boxes, a repeat bit-equal), the DCN
   config's maps against the CPU on SMALL_GRID, one deformable branch's
   ms beside its bound, ``dist_test`` of the DCN config (FPS, every frame
   bit-equal to a direct ``predict``, the nuScenes metrics and results
   json), its train step at batch 4 (:func:`timed_train_steps`) and two
   train-CLI steps (:func:`nusc_phase`). The kernel phase holds the stem
   at C_in 10 and 8 over the 345,000-row buffer, the scatter-max at the
   three canvases and its float32 entry at the DCN train step's batch of
   4 (:func:`nusc_kernel_cases`). Then the single-head cylinder config
   (``voxelnet_det_cylinder_singlehead.py``: ``CenterHeadSinglePos``, one
   task of 10 classes, rectified decode, the per-class NMS over all
   16,384 candidates) on the same set (:func:`singlehead_phase`): its
   frame (median ms, device busy and launches, the stem and scatter-max
   once a frame at the DCN config's kernel shapes), its decode + NMS
   alone (ms, fixpoint sweeps, the suppression matrix's device ms), the
   card against the CPU on SMALL_GRID (maps, and the kept boxes of the
   CPU's BEV through each side's RPN, head, decode and NMS), the train
   step at batch 4, ``dist_test`` over 8 frames bit-equal to ``predict``
   and two train-CLI steps.
15. PointPillars: the two Waymo PointPillars configs
   (``configs/waymo/pp/waymo_centerpoint_pp{,_two_cls}_two_pfn_stride1_
   3x.py``: ``dynamic_voxelize`` on the 468 x 468 pillar grid at the
   32,768-pillar capacity, the two-layer PFN with its pooled max, the
   scatter, the float32 ``RPN`` and ``CenterHead`` at stride 1) at full
   width, random weights with norms and the PFN's norms randomized, on a
   cuboid 180,000-point sweep in 216,000 rows: each config's frame (median
   ms, device busy and launches, kept boxes, finite maps, a repeat
   bit-equal, pillars occupied against the capacity and the points in
   dropped pillars); the canvas, RPN output and head maps of the card
   against the CPU on a 128 x 128 pillar grid (float32 both sides) and the
   kept detections; for the 3-class config the train step at batch 4
   (150,000 points a sample in 180,000 rows, 32-64 boxes), ``dist_test``
   from a port checkpoint over 8 frames, each bit-equal to a direct
   ``predict``, and two train-CLI steps (:func:`pp_phase`). Then the
   two-stage pair (``configs/waymo/pp/two_stage/*.py``, the frozen
   PointPillars first stage, RoI head 1921 -> 256 -> 256;
   :func:`pp_two_stage_phase`): the 3-class frame taking turns with its
   one-stage frame, the refine stage's device ms and launches, the card
   against the CPU on 128 x 128 pillars (neck map, refine, kept boxes),
   the frozen step at batch 4 from a port one-stage checkpoint the phase
   writes, two train-CLI steps through ``pretrained`` and ``dist_test``,
   and the 2-class frame. No hand kernel lies on these paths; the phase
   holds every kernel's launches at 0.
16. PolarStream: the two nuScenes sector-streaming det configs
   (``configs/nusc/pp/polarstream_det_{1_sector,4_sector_bidirectional}
   .py``: the 512 x 512 polar pillar grid in 1 or 4 azimuth sectors,
   ``DynamicPFNet`` 64 -> 128, ``RPNTECP`` / ``RPNBDCP`` [3, 5, 5],
   ``CenterHeadSinglePos``, the stateful cross-sector NMS) at full width
   on a synthetic 11-sweep nuScenes set, every row of a sample in a
   380,000-row buffer (:func:`polarstream_phase`): each config's frame
   (median ms, device busy and launches, kept boxes, a repeat bit-equal),
   its decode + stateful NMS alone (ms, fixpoint sweeps a sector), pillars
   occupied against the capacity per sector and the points the caps drop,
   the card against the CPU on a 128 x 128 pillar grid (canvas, neck and
   its contexts, head maps per sector, kept boxes), the batch-4 train
   step, ``dist_test`` over 8 frames (as a user runs it, then with one
   loader thread, every frame bit-equal to a direct ``predict``) and two
   train-CLI steps. No hand kernel lies on this path: every launch count
   stays 0.

17. data parallelism (:func:`dist_phase`): an NCCL group of one in
   process, the flagship's float32 train step data-parallel
   (``DistributedDataParallel`` with the global BatchNorm statistics and
   loss normalizers) against the plain step from the same weights, batch
   and draws (loss terms, gradients, the parameters after the step where
   Adam's first step is determined, statistics; times each way,
   collectives a step, the scatter-max once a step); the lr family's sgd, amsgrad and adamw on the card against CPU copies,
   and the lrs against the schedule; then ``dist_test`` and the train CLI
   through ``python -m torch.distributed.run --standalone
   --nproc_per_node 1``: predictions bit-equal to the run without a group,
   the stem, attention and scatter-max kernels launched, finite losses and
   the schedule's lr. The card holds one process: two ranks are the CPU
   tests' (``tests/test_torch_dist*.py``).
18. tools (:func:`tools_phase`): the host tools and the FLOP counter
   without JAX. ``dist_test`` of the flagship over 10 fake Waymo frames of
   one sequence (40 boxes moving at constant velocities, the poses in the
   annos' ``veh_to_global`` only) prepared by ``create_data``, then
   ``tools.track`` over its predictions (tracked boxes, launches); the
   ground-truth boxes with their velocities as detections, tracked to
   MOTA 1.0 with no id switch, and a 2 x 2 ``track_line_search``;
   ``nms_ensemble`` of the predictions and a perturbed copy on the card,
   each frame's kept boxes equal to the CPU's (ms a frame);
   ``CSWinBlock`` at the flagship BEV (1, 144, 256, 256), 8 heads, both
   stage kinds in float32 against the CPU (median ms, peak memory);
   ``flops_report`` on the full-size flagship, its table equal on the
   card's kernel route and on the CPU's plain twins, with the MFU of the
   median frame against ``utils.flops.device_peak_flops()``;
   ``write_ply_scene``, ``box_corners_bev``, ``generate_instance_ids``
   and, where matplotlib is installed, the demo CLI.

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


# The card the bounds are of, and its published HBM3 rate (NVIDIA's data
# sheet), bytes/s; its peak FLOP/s are partner_tpu_torch.utils.flops'.
H100_SXM = "NVIDIA H100 80GB HBM3"
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
    from partner_tpu_torch.utils.flops import device_peak_flops

    t_bytes = work["bytes"] / PEAK_BYTES * 1e3
    t_ops = max([f / device_peak_flops(k, H100_SXM) * 1e3
                 for k, f in work["flops"].items()] or [0.0])
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

def stem_case(gen, dev, cin=10, n_points=N_POINTS, batch=1, rows=None):
    """Stem inputs at a point-path shape, bf16: the flagship's (1, 10,
    216,000) by default; (1, 11, 432,000) for the two-sweep CenterPoint
    config (cin 11, 2 x N_POINTS points); (4, 10, 180,000) for a train
    step's batch (``batch`` 4 of TRAIN_POINTS); the same 1.2x padding, or
    ``rows`` rows (the nuScenes buffer, C_in 8)."""
    from partner_tpu_torch.ops import stem

    p = rows or int(n_points * 1.2)
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


def nusc_scatter_case(stem_out, dev, config):
    """Scatter-max inputs at a nuScenes config's canvas (``PolarDenseFHD``
    pools 4 x 4 cells in the plane and 8 layers in z): the stem's (B, 64,
    NUSC_ROWS) output and the canvas coords of B synthetic 10-sweep
    samples (:func:`nusc_sweep_points`, NUSC_SAMPLE_POINTS each, seeds
    SEED + 30, ...) in the config's layout, rows past a sample masked."""
    m, _, _ = centerpoint_cfgs(config)
    vg = m["bbox_head"]["voxel_generator"]
    pr = vg["range"]
    grid = [int(round((pr[3 + i] - pr[i]) / vg["voxel_size"][i]))
            for i in range(3)]
    canvas = (grid[2] // 8, grid[1] // 4, grid[0] // 4)     # (cz, cy, cx)
    cell = np.asarray([(pr[3] - pr[0]) / grid[0] * 4,
                       (pr[4] - pr[1]) / grid[1] * 4,
                       (pr[5] - pr[2]) / grid[2] * 8], np.float32)
    b, _, rows = stem_out.shape
    coords = np.zeros((b, 3, rows), np.int32)
    inb = np.zeros((b, rows), bool)
    for i in range(b):
        xyz = nusc_sweep_points(np.random.RandomState(SEED + 30 + i),
                                NUSC_SAMPLE_POINTS, np.zeros((0, 9)))[:, :3]
        if vg["voxel_shape"] == "cylinder":
            xyz = np.stack([np.hypot(xyz[:, 0], xyz[:, 1]),
                            np.arctan2(xyz[:, 1], xyz[:, 0]), xyz[:, 2]], 1)
        idx = np.floor((xyz - np.asarray(pr[:3], np.float32)) / cell)
        idx = idx.astype(np.int32)                           # r|x, az|y, z
        n = len(idx)
        coords[i, :, :n] = idx[:, ::-1].T
        inb[i, :n] = np.all((idx >= 0) & (idx < np.asarray(canvas[::-1])), 1)
    return (stem_out, torch.from_numpy(coords).to(dev),
            torch.from_numpy(inb).to(dev), canvas)


def nusc_kernel_cases(results, dev, card):
    """The nuScenes shapes, over NUSC_ROWS rows (a ragged last m-tile):
    the stem at C_in 10 (the cylinder configs' 7 point features + 3
    decorations) at batch 1 and at C_in 8 (the cuboid flip config's 5 + 3)
    at batch 1 and at the flip batch of 4, under :func:`compare_stem`'s
    rule; the scatter-max of their outputs into each config's canvas (the
    DCN and 01voxel cylinders from the C_in 10 output, the flip config's
    cuboid from the C_in 8 batch of 4), and the float32 entry at the DCN
    train step's batch of 4 into the DCN canvas, exactly. Drawn from
    generators of their own; results land in ``results`` under
    ``*_nusc_b1`` / ``*_nusc_b4`` (stem, C_in 8), ``*_nusc_c10_b1`` (stem,
    C_in 10), ``*_nusc_<config>`` and ``*_nusc_dcn_train_f32``
    (scatter-max)."""
    from partner_tpu_torch.ops import scatter_max, stem

    outs = {}
    for cin, batch, tag in ((8, 1, "b1"), (8, 4, "b4"), (10, 1, "c10_b1")):
        args = stem_case(torch.Generator().manual_seed(SEED + 40 + batch
                                                       + 10 * (cin - 8)),
                         dev, cin=cin, n_points=NUSC_SAMPLE_POINTS,
                         batch=batch, rows=NUSC_ROWS)
        shape = tuple(args[0].shape)
        out = stem.stem2_channel_major(*args)
        ref = stem.stem2_channel_major_plain(*args)
        torch.cuda.synchronize()
        err = compare_stem(f"stem2_channel_major nuScenes {shape}", out, ref,
                           args)
        r = dict(max_abs_err=err, **not_equal(f"stem {shape}", out, ref),
                 **timed("stem", args,
                         lambda: stem.stem2_channel_major(*args),
                         lambda: stem.stem2_channel_major_plain(*args),
                         label=f"stem nuScenes {shape} on {card}"))
        results["stem"]["max_abs_err"] = max(results["stem"]["max_abs_err"],
                                             err)
        results["stem"].update({f"{k}_nusc_{tag}": v for k, v in r.items()
                                if not k.startswith("library")})
        outs[cin, batch] = ref
        del args, out
    for name, key, entry in (("dcn", (10, 1), "dcn"),
                             ("01voxel", (10, 1), "01voxel"),
                             ("dcn_flip", (8, 4), "dcn_flip"),
                             ("dcn", (8, 4), "dcn_train_f32")):
        sargs = nusc_scatter_case(outs[key], dev, NUSC_CONFIGS[name])
        if entry.endswith("f32"):   # the train step's float32 features
            sargs = (sargs[0].float(),) + tuple(sargs[1:])
        out = scatter_max.scatter_max_fold2d(*sargs)
        ref = scatter_max.scatter_max_fold2d_plain(*sargs)
        torch.cuda.synchronize()
        cz, cy, cx = sargs[3]
        label = (f"scatter_max nuScenes {entry} {tuple(sargs[0].shape)} "
                 f"{sargs[0].dtype} -> {(key[1], cy, cx, 64 * cz)}")
        log(f"{label}: {sargs[2].sum(1).tolist()} of {sargs[2].shape[1]} "
            "rows a sample in the canvas")
        err = compare(label, out, ref, 0.0)
        r = dict(max_abs_err=err, **not_equal(label, out, ref),
                 **timed("scatter_max", sargs,
                         lambda: scatter_max.scatter_max_fold2d(*sargs),
                         lambda: scatter_max.scatter_max_fold2d_plain(*sargs),
                         scatter_library_call(*sargs),
                         label=f"{label} on {card}"))
        results["scatter_max"]["max_abs_err"] = max(
            results["scatter_max"]["max_abs_err"], err)
        results["scatter_max"].update({f"{k}_nusc_{entry}": v
                                       for k, v in r.items()})
        del sargs, out, ref
    torch.cuda.empty_cache()


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
    nusc_kernel_cases(results, dev, card)
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
    from partner_tpu_torch.models.center_head import GroupNorm, RSNorm
    from partner_tpu_torch.models.layers import BatchNorm

    def draw(t, positive):
        t.copy_(0.5 + torch.rand(t.shape, generator=gen) if positive
                else 0.2 * torch.randn(t.shape, generator=gen))

    for name, t in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        is_norm = isinstance(module.get_submodule(owner_name),
                             (torch.nn.LayerNorm, BatchNorm, GroupNorm,
                              RSNorm))
        if leaf == "tau" or leaf.endswith("_scale") or (
                is_norm and leaf in ("weight", "scale")):
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


def check_detections(out, tc, box_dim=7, n_tasks=1):
    post = tc["nms"]["nms_post_max_size"] * n_tasks
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
    if not 0 < n_kept < tc["nms"]["nms_pre_max_size"] * n_tasks:
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


def timed_train_steps(det, step, ex, drops, want, label,
                      n_steps=TRAIN_STEPS):
    """One warm-up and ``n_steps`` timed calls of ``step(ex, drops)``,
    each :func:`counted` and launching ``want``, with finite metrics (each
    task's too) and a gradient norm > 0; after them every parameter's
    gradient present and finite, and every parameter and BatchNorm
    statistic of ``det`` moved. -> (launches summed over every step,
    median host ms of the timed steps, all their ms, each step's metrics
    as floats, peak memory in GiB since the caller's reset)."""
    before = {k: v.detach().clone() for k, v in det.module.state_dict().items()}
    times, launches, steps = [], dict.fromkeys(want, 0), []
    for i in range(n_steps + 1):   # step 0 warms up
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


def device_busy(run, calls=1):
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
            f"(torch.profiler, 1 frame); launches over {frames} frames "
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
def centerpoint_reference(dev, card, config=CP_CONFIG, name="CenterPoint",
                          seed=SEED + 7, head_tol=REF_BF16):
    """A CenterPoint config's widths on SMALL_GRID, same weights and
    points: the backbone BEV and each task's head maps of the card (bf16
    backbone with the stem and scatter kernels; a DCN head's offset convs
    drawn too) against the CPU (float32, plain twins), each stage fed the
    CPU's input; the RPN and head within ``head_tol``. -> (the card's
    detector, the CPU's, the CPU's backbone BEV)."""
    from partner_tpu_torch.models import build_detector

    m, _, tc = centerpoint_cfgs(config, grid=SMALL_GRID)
    gen = torch.Generator().manual_seed(seed)
    gdet = build_detector(m, None, tc, device=dev, generator=gen)
    gpu = gdet.module
    randomize_norms(gpu, gen)
    randomize_offsets(gpu, gen)
    m32, _, _ = centerpoint_cfgs(config, grid=SMALL_GRID,
                                 compute_dtype="float32")
    cdet = build_detector(m32, None, tc, device="cpu")
    cpu = cdet.module
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    pts, mask = synthetic_sweep(np.random.RandomState(seed),
                                m["bbox_head"]["voxel_generator"]["range"],
                                30_000)
    exc = to_device({"points": pts, "points_mask": mask}, "cpu")
    exg = to_device({"points": pts, "points_mask": mask}, dev)
    bev = cpu.backbone.encode_points(exc["points"], exc["points_mask"],
                                     cpu.grid_size, cpu.pc_range)
    rel_rms(f"{name} backbone BEV on {card}",
            gpu.backbone.encode_points(exg["points"], exg["points_mask"],
                                       gpu.grid_size, gpu.pc_range),
            bev, REF_BF16)
    want = cpu.bbox_head(cpu.neck(bev))["det_preds"]
    got = gpu.bbox_head(gpu.neck(bev.to(dev)))["det_preds"]
    for task, (g, w) in enumerate(zip(got, want)):
        for k in sorted(w):
            rel_rms(f"{name} RPN + head task{task} {k}", g[k], w[k],
                    head_tol)
    return gdet, cdet, bev


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
        f"(torch.profiler, 1 frame); kernel launches over {FRAMES} frames "
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


def fake_waymo_frame(rng, frame_id, n_objects=40, ego_step=10.0):
    """A Waymo frame as ``data.waymo_decoder`` reads one (dicts in place of
    the protos, numpy range images in place of zlib payloads): the TOP
    lidar's 64 x 2650 range image mounted 2 m up, ranges log-uniform over
    2-75 m and cut where a downward beam meets the ground, 2% of pixels in
    the no-label zone, a second return on 10% of pixels, the per-pixel
    pose of a car moving ``ego_step`` m a frame along x (the
    rolling-shutter path), and ``n_objects`` labels of the three classes
    in turn centered on returns of the first."""
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
    pose_ri[..., 3] = ego_step * frame_id + np.linspace(0.5, -0.5, w)[None]
    frame_pose = np.eye(4)
    frame_pose[0, 3] = ego_step * frame_id
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
        f"frame {busy!r} (torch.profiler, 1 frame); the refine stage "
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


# ---------------------------------------------------------------- nuScenes

NUSC_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
                "barrier", "motorcycle", "bicycle", "pedestrian",
                "traffic_cone")
NUSC_SIZES = ((4.6, 1.9, 1.7), (6.9, 2.5, 2.8), (6.5, 2.8, 3.2),
              (11.0, 2.9, 3.5), (12.0, 2.9, 3.9), (0.5, 2.5, 1.0),
              (2.1, 0.8, 1.5), (1.7, 0.6, 1.3), (0.7, 0.7, 1.8),
              (0.4, 0.4, 1.1))
LIDAR_BEAMS = 32             # the nuScenes lidar: 32 beams, -30.67..10.67 deg
LIDAR_HEIGHT = 1.84          # metres above the ground
NUSC_SWEEP_POINTS = 34_000   # returns a sweep of that lidar
NUSC_SWEEPS = 10             # the configs' nsweeps
NUSC_SAMPLE_POINTS = NUSC_SWEEPS * NUSC_SWEEP_POINTS
NUSC_ROWS = 345_000          # --max_points: every point of a sample
NUSC_DIR = os.path.join(ROOT, "configs", "nusc", "voxelnet")
NUSC_CONFIGS = {n: os.path.join(NUSC_DIR, f"nusc_centerpoint_voxelnet_{n}.py")
                for n in ("dcn", "01voxel", "dcn_flip")}
# the single-head cylinder baseline: CenterHeadSinglePos, per-class NMS
NUSC_SINGLEHEAD = os.path.join(NUSC_DIR, "voxelnet_det_cylinder_singlehead.py")
NUSC_ALL = dict(NUSC_CONFIGS, singlehead=NUSC_SINGLEHEAD)


def nusc_sweep_points(rng, n_points, boxes):
    """One synthetic 32-beam sweep in its own lidar frame: about
    ``n_points`` float32 rows [x, y, z, intensity, ring] of beams hitting
    the ground or a wall 8-60 m out, a share of them inside the ``boxes``
    and 1% off the ego vehicle within a metre of the sensor."""
    n_az = max(1, n_points // LIDAR_BEAMS)
    elev = np.deg2rad(np.linspace(-30.67, 10.67, LIDAR_BEAMS))
    az = rng.uniform(-np.pi, np.pi, (LIDAR_BEAMS, n_az))
    wall = rng.uniform(8.0, 60.0, (LIDAR_BEAMS, n_az))
    ground = np.where(elev < 0, LIDAR_HEIGHT / np.tan(-np.minimum(elev,
                                                                  -1e-3)),
                      np.inf)[:, None]
    r = np.minimum(wall, ground) * (1 + 0.01 * rng.randn(LIDAR_BEAMS, n_az))
    xy = r * np.cos(elev)[:, None]
    pts = np.stack([xy * np.cos(az), xy * np.sin(az),
                    r * np.sin(elev)[:, None],
                    rng.rand(LIDAR_BEAMS, n_az) * 100,
                    np.broadcast_to(np.arange(LIDAR_BEAMS)[:, None],
                                    az.shape)], -1).reshape(-1, 5)
    n_obj = min(len(pts) // 4, 60 * len(boxes))
    if len(boxes):
        b = boxes[rng.randint(0, len(boxes), n_obj)]
        local = (rng.rand(n_obj, 3) - 0.5) * b[:, 3:6]
        c, sn = np.cos(b[:, -1]), np.sin(b[:, -1])
        pts[:n_obj, 0] = b[:, 0] + local[:, 0] * c - local[:, 1] * sn
        pts[:n_obj, 1] = b[:, 1] + local[:, 0] * sn + local[:, 1] * c
        pts[:n_obj, 2] = b[:, 2] + local[:, 2]
    # returns off the ego vehicle's roof, within a metre of the sensor
    n_ego = len(pts) // 100
    pts[-n_ego:, :2] = rng.uniform(-0.9, 0.9, (n_ego, 2))
    pts[-n_ego:, 2] = rng.uniform(-0.3, 0.0, n_ego)
    return pts[:n_points].astype(np.float32)


def yaw_quaternion(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


# a lidarseg raw id of each detection class (NUSC_CLASSES order), and of
# stuff: driveable surface, sidewalk, terrain, manmade, vegetation
LIDARSEG_THING_IDS = (17, 23, 18, 15, 22, 9, 21, 14, 2, 12)
LIDARSEG_STUFF_IDS = (24, 26, 27, 28, 30)


def lidarseg_ids(rng, points, boxes, names):
    """Raw lidarseg ids (uint8) of a key frame's points: the id of a box's
    class inside it, a ground id on the ground (z within 0.3 m of the
    sensor's height below), another stuff id elsewhere, and 2% noise (id
    0, ignored)."""
    ids = np.asarray(LIDARSEG_STUFF_IDS)[rng.randint(
        1, len(LIDARSEG_STUFF_IDS), len(points))]
    ids[points[:, 2] < -LIDAR_HEIGHT + 0.3] = LIDARSEG_STUFF_IDS[0]
    for box, name in zip(boxes, names):
        c, s = np.cos(-box[-1]), np.sin(-box[-1])
        dx, dy = points[:, 0] - box[0], points[:, 1] - box[1]
        inside = ((np.abs(dx * c - dy * s) <= box[3] / 2)
                  & (np.abs(dx * s + dy * c) <= box[4] / 2)
                  & (np.abs(points[:, 2] - box[2]) <= box[5] / 2))
        ids[inside] = LIDARSEG_THING_IDS[NUSC_CLASSES.index(name)]
    ids[rng.rand(len(points)) < 0.02] = 0
    return ids.astype(np.uint8)


def write_nusc_scene(root, rng, n_frames, nsweeps, n_points, n_boxes=40,
                     version="v1.0-trainval", lidarseg=False):
    """A synthetic nuScenes set under ``root`` in the layout the loader
    reads, made into infos by the port's ``create_data
    nuscenes_data_prep``: per frame a key-frame ``.bin`` of ``n_points``
    rows (:func:`nusc_sweep_points`), ``nsweeps - 1`` earlier sweeps, each
    its own ``.bin`` with a ``transform_matrix`` (the ego's motion, 0.05 s
    a sweep) and ``time_lag``, ``n_boxes`` gt boxes (N, 9) of the ten
    classes with velocities, and the lidar -> ego -> global calibration.
    With ``lidarseg`` each key frame also gets a lidarseg ``.bin``
    (:func:`lidarseg_ids`, drawn from ``rng`` after everything else) and
    its info a ``lidarseg_path``, which no ``create_data`` writes.
    -> the infos' path."""
    import pickle

    from partner_tpu_torch.tools import create_data

    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)
    frames = []
    for i in range(n_frames):
        cls = rng.randint(0, len(NUSC_CLASSES), n_boxes)
        rho, phi = rng.uniform(4, 45, n_boxes), rng.uniform(-np.pi, np.pi,
                                                            n_boxes)
        boxes = np.zeros((n_boxes, 9), np.float32)
        boxes[:, 0], boxes[:, 1] = rho * np.cos(phi), rho * np.sin(phi)
        boxes[:, 3:6] = np.asarray(NUSC_SIZES)[cls]
        boxes[:, 2] = boxes[:, 5] / 2 - LIDAR_HEIGHT
        boxes[:, 6:8] = rng.randn(n_boxes, 2) * 2
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, n_boxes)
        key = os.path.join(root, "samples", f"frame{i}.bin")
        nusc_sweep_points(rng, n_points, boxes).tofile(key)
        sweeps = []
        for k in range(1, nsweeps):
            lag = 0.05 * k
            yaw = 0.02 * k * rng.randn()
            t = np.eye(4)
            t[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw),
                                                       np.cos(yaw)]]
            t[:3, 3] = [-8.0 * lag, 0.3 * rng.randn(), 0.0]
            path = os.path.join(root, "sweeps", f"frame{i}_sweep{k}.bin")
            nusc_sweep_points(rng, n_points, boxes).tofile(path)
            sweeps.append({"lidar_path": path, "transform_matrix": t,
                           "time_lag": lag})
        frames.append({
            "token": f"nusc{i:04d}", "lidar_path": key, "sweeps": sweeps,
            "gt_boxes": boxes,
            "gt_names": np.asarray(NUSC_CLASSES)[cls],
            "timestamp": 1_533_000_000_000_000 + 500_000 * i,
            "lidar2ego_rotation": yaw_quaternion(-np.pi / 2),
            "lidar2ego_translation": [0.94, 0.0, LIDAR_HEIGHT],
            "ego2global_rotation": yaw_quaternion(0.3 * i),
            "ego2global_translation": [400.0 + 5 * i, 1100.0, 0.0]})
    frames_pkl = os.path.join(root, "frames.pkl")
    with open(frames_pkl, "wb") as f:
        pickle.dump(frames, f)
    info_path = create_data.main(["nuscenes_data_prep", "--root_path", root,
                                  "--version", version, "--nsweeps",
                                  str(nsweeps), "--frames_pkl", frames_pkl])
    if lidarseg:
        os.makedirs(os.path.join(root, "lidarseg"), exist_ok=True)
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        for i, (info, frame) in enumerate(zip(infos, frames)):
            pts = np.fromfile(frame["lidar_path"], np.float32).reshape(-1, 5)
            path = os.path.join(root, "lidarseg", f"frame{i}_lidarseg.bin")
            lidarseg_ids(rng, pts, frame["gt_boxes"],
                         frame["gt_names"]).tofile(path)
            info["lidarseg_path"] = path
        with open(info_path, "wb") as f:
            pickle.dump(infos, f)
    return info_path


NUSC_FRAMES = 8              # frames on disk, and dist_test's frames
NUSC_TIMED = 3               # timed frames a config after one warm-up
NUSC_TRAIN_BATCH = 4         # the configs' samples_per_gpu


def nusc_example(name, seed=SEED, config=None, sweeps=NUSC_SWEEPS,
                 rows=NUSC_ROWS):
    """One synthetic nuScenes sample of ``sweeps`` sweeps (NUSC_SWEEP_POINTS
    points a sweep of :func:`nusc_sweep_points`, [x, y, z, intensity, time
    lag] with the lags of the sweeps) in the layout config ``name``'s (of
    NUSC_ALL; or the file ``config``) pipeline gives it, padded to ``rows``
    rows; for the flip config its four copies (the ``DoubleFlip`` rows) ->
    {"points", "points_mask"} numpy."""
    from partner_tpu_torch.core.box_np_ops import transform_points
    from partner_tpu_torch.data.pipeline import DoubleFlip
    from partner_tpu_torch.utils.config import load_config

    rng = np.random.RandomState(seed)
    pts = nusc_sweep_points(rng, sweeps * NUSC_SWEEP_POINTS, np.zeros((0, 9)))
    pts[:, 4] = 0.05 * rng.randint(0, sweeps, len(pts))
    cfg = load_config(config or NUSC_ALL[name])
    pts = transform_points(pts, cfg["voxel_generator"]["voxel_shape"])
    copies = [pts]
    if cfg["test_cfg"].get("double_flip"):
        lidar = DoubleFlip()({"lidar": {"points": pts}}, None)[0]["lidar"]
        copies += [lidar[k] for k in ("yflip_points", "xflip_points",
                                      "double_flip_points")]
    out = np.zeros((len(copies), rows, pts.shape[1]), np.float32)
    mask = np.zeros(out.shape[:2], bool)
    for i, c in enumerate(copies):
        out[i, :len(c)], mask[i, :len(c)] = c, True
    return {"points": out, "points_mask": mask}


def write_nusc_config(root, name, info_path, config=None):
    """The nuScenes config ``name`` (of ``NUSC_ALL``, or the file
    ``config``) with ``score_threshold`` 0 (as :func:`centerpoint_cfgs`),
    ``data.train`` / ``data.val`` at the synthetic set, and a metrics
    record every step."""
    path = os.path.join(root, f"nusc_{name}.py")
    config = config or NUSC_ALL[name]
    with open(path, "w") as f:
        f.write(f"__file__ = {config!r}\n"
                f"exec(open({config!r}).read())\n"
                "test_cfg['score_threshold'] = 0.0\n"
                "for _s in ('train', 'val'):\n"
                f"    data[_s].update(info_path={info_path!r}, "
                f"root_path={root!r})\n"
                "log_config = dict(interval=1, hooks=[dict(type="
                "'TextLoggerHook'), dict(type='MetricsSinkHook')])\n")
    return path


@torch.no_grad()
def randomize_offsets(module, gen):
    """Draw each deformable branch's offset conv (zero at init, which makes
    the branch a plain 3x3 conv) from ``gen``: N(0, 0.05) on 64 channels
    of features near 1 moves the samples by fractions of a cell."""
    for name, m in module.named_modules():
        if name.endswith("conv_offset"):
            m.weight.copy_(0.05 * torch.randn(m.weight.shape, generator=gen))


def nusc_batch(cfg_path, mode, samples, seed=SEED, rows=NUSC_ROWS,
               n_sectors=None):
    """The first ``samples`` frames of the config's ``mode`` set through the
    port's data path (draws from ``RandomState(seed)``), collated to
    ``rows`` rows. ``n_sectors`` sets each ``AssignLabel`` to the model's
    sector count, as the train CLI does (``tools.train.sector_targets``:
    the HAN and STROBE 4-sector configs' pipelines keep the 1-sector
    assigner, ROADMAP.md §3)."""
    import logging

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.collate import collate
    from partner_tpu_torch.tools.train import sector_targets
    from partner_tpu_torch.utils.config import load_config

    data = dict(load_config(cfg_path)["data"][mode])
    if n_sectors is not None:
        data = sector_targets(data, n_sectors, logging.getLogger(__name__),
                              cfg_path)
    ds = build_dataset(data, dict(rng=np.random.RandomState(seed)))
    return collate([ds[i] for i in range(samples)], max_points=rows)


def deform_conv_work(x, fa):
    """FLOPs and bytes of one ``FeatureAdaption`` call on ``x`` (B, H, W, C):
    its 1x1 offset conv and the deformable product in float32 (the
    bilinear gather's arithmetic beside them not counted); x and the
    weights read once, the offsets written and read once, the output
    written once."""
    b, h, w, c = x.shape
    k, _, cout = fa.deform_kernel.shape
    n_off = fa.conv_offset.weight.shape[0]
    flops = 2 * b * h * w * (c * n_off + k * c * cout)
    nbytes = 4 * (x.numel() + 2 * b * h * w * n_off + b * h * w * cout
                  + fa.deform_kernel.numel() + fa.conv_offset.weight.numel())
    return {"flops": {"f32": flops}, "bytes": nbytes}


def nusc_phase(dev, card):
    """The three nuScenes CenterPoint configs at full width on a synthetic
    10-sweep set prepared by the port's ``create_data``: each config's
    frame through ``predict`` (the flip config on its 4 copies), the DCN
    head against the CPU on SMALL_GRID, one deformable branch alone,
    ``dist_test`` of the DCN config bit-equal to direct predicts, its train
    step at batch 4 and two train-CLI steps; then the single-head config
    on the same set (:func:`singlehead_phase`)."""
    import tempfile

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    res = {}
    per_frame = {"stem": 1, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        info = write_nusc_scene(root, np.random.RandomState(SEED + 20),
                                NUSC_FRAMES, NUSC_SWEEPS, NUSC_SWEEP_POINTS)
        log(f"nuScenes set: {NUSC_FRAMES} frames of {NUSC_SWEEPS} sweeps of "
            f"~{NUSC_SWEEP_POINTS} points written and prepared by "
            f"create_data nuscenes_data_prep in "
            f"{time.perf_counter() - t0:.1f} s")
        cfgs = {n: write_nusc_config(root, n, info) for n in NUSC_CONFIGS}
        dets = {}
        for name in NUSC_CONFIGS:
            cfg = load_config(cfgs[name])
            tc = dict(cfg["test_cfg"])
            gen = torch.Generator().manual_seed(SEED + 22)
            det = build_detector(cfg["model"], cfg["train_cfg"], tc,
                                 device=dev, generator=gen)
            randomize_norms(det.module, gen)
            randomize_offsets(det.module, gen)
            t0 = time.perf_counter()
            batch = nusc_batch(cfgs[name], "val", 1)
            host_ms = (time.perf_counter() - t0) * 1e3
            rows = batch["points_mask"].sum(1)
            if name == "dcn":
                log(f"nuScenes sample: {int(rows[0])} points in "
                    f"{NUSC_SWEEPS} sweeps (key frame "
                    f"{batch['metadata'][0]['n_key_points']}); the default "
                    f"--max_points 200000 would drop "
                    f"{max(0, int(rows[0]) - 200_000)} of them; buffer "
                    f"{NUSC_ROWS} rows drops none; one sample through the "
                    f"val pipeline in {host_ms:.1f} ms on the host")
            if int(rows.max()) >= NUSC_ROWS:
                raise AssertionError(f"nuScenes {name}: the buffer is full")
            ex = to_device({k: batch[k] for k in ("points", "points_mask")},
                           dev)
            median, times, out, tally = timed_predicts(det, ex, NUSC_TIMED,
                                                       per_frame)
            busy, launches = device_busy(lambda: det.predict(ex))
            with torch.no_grad():
                maps = det.module(ex)["det_preds"]
            if not all(torch.isfinite(v).all() for t in maps for v in
                       t.values()):
                raise AssertionError(f"nuScenes {name}: non-finite maps")
            kept = check_detections(out, tc, box_dim=9, n_tasks=6)
            if not identical(det.predict(ex), out):
                raise AssertionError(f"nuScenes {name}: a repeat differs")
            log(f"nuScenes {name} frame on {card}: {tuple(ex['points'].shape)}"
                f" point rows, median {median!r} ms over {NUSC_TIMED} frames,"
                f" all {times!r}; device busy {busy!r} ms and {launches!r} "
                f"launches a frame; kernel launches {tally}; {kept} boxes "
                f"kept over 6 tasks; repeat bit-equal")
            res[name] = dict(median_ms=median, device_busy_ms=busy,
                             launches_per_frame=launches, launches=tally,
                             kept=kept, rows=int(rows.max()))
            if name == "dcn":
                with torch.no_grad():
                    mod = det.module
                    bev = mod.backbone.encode_points(
                        ex["points"], ex["points_mask"], mod.grid_size,
                        mod.pc_range)
                    x = torch.relu(mod.bbox_head.Conv_0(mod.neck(bev)))
                    fa = mod.bbox_head.task0.feature_adapt_cls
                    r = call_and_device_ms("ms", lambda: fa(x))
                b_ms, b_by = bound(deform_conv_work(x, fa))
                r.update(bound_ms=b_ms, bound_by=b_by, calls_a_frame=12,
                         shape=tuple(x.shape))
                log(f"deformable conv (FeatureAdaption, plain torch) at "
                    f"{tuple(x.shape)} on {card}: {r['ms']!r} ms a call "
                    f"({r['device_ms']!r} device), bound {b_ms!r} ms by "
                    f"{b_by}; 12 calls a frame (6 tasks x 2 branches)")
                res["deform_conv"] = r
                dets[name] = det
            else:
                del det
            del maps, out, ex
            torch.cuda.empty_cache()

        # the float32 RPN and heads against the CPU's: summation order
        centerpoint_reference(dev, card, NUSC_CONFIGS["dcn"], "nuScenes DCN",
                              SEED + 21, REF_F32)

        # ---- dist_test of the DCN config, bit-equal to direct predicts
        det = dets.pop("dcn")
        res["dist_test"] = nusc_dist_test(det, cfgs["dcn"], root, "dcn",
                                          card, per_frame)
        res["train"] = nusc_train_step(det, cfgs["dcn"], "DCN", card)
        del det
        torch.cuda.empty_cache()
        res["train_cli"] = nusc_train_cli(cfgs["dcn"], root, "dcn", card, dev)
        res["singlehead"] = singlehead_phase(dev, card, root, info)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"nuScenes phase peak memory {res['peak_gib']!r} GiB, "
        f"{time.perf_counter() - t_phase:.1f} s in all")
    return res


def nusc_dist_test(det, cfg_path, root, name, card, per_frame):
    """``dist_test`` of a nuScenes config from a checkpoint of ``det``'s
    weights over the NUSC_FRAMES synthetic frames: the launches
    ``per_frame`` a frame, every frame bit-equal to a direct ``predict``,
    finite nuScenes metrics and the results json. -> {fps, launches}."""
    import pickle

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.utils.config import load_config

    ckpt = os.path.join(root, f"ckpt_{name}")
    save_checkpoint(ckpt, 0, det.module.state_dict())
    work_dir = os.path.join(root, f"eval_{name}")
    dev = next(det.module.parameters()).device
    _, ((metrics, seg, pan), fps), dist_launches = counted(
        lambda: dist_test.main([
            cfg_path, "--checkpoint", os.path.join(ckpt, "latest"),
            "--work_dir", work_dir, "--max_points", str(NUSC_ROWS),
            "--device", dev.type]))
    with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
        preds = pickle.load(f)
    ds = build_dataset(dict(load_config(cfg_path)["data"]["val"]))
    direct = {}
    for b in DataLoader(ds, 1, shuffle=False, max_points=NUSC_ROWS):
        e = to_device({k: b[k] for k in ("points", "points_mask")}, dev)
        direct[b["metadata"][0]["token"]] = kept_boxes(det.predict(e))
    want = {k: n * NUSC_FRAMES for k, n in per_frame.items()}
    if dist_launches != want:
        raise AssertionError(f"nuScenes dist_test ({name}): launches "
                             f"{dist_launches} != {want}")
    if sorted(preds) != sorted(direct) or not all(
            np.array_equal(preds[t][k], direct[t][k])
            for t in direct for k in direct[t]):
        raise AssertionError(f"nuScenes dist_test ({name}): a frame "
                             "differs from a direct predict")
    keys = ["mAP", "NDS", "mATE", "mASE", "mAOE", "mAVE"]
    if seg is not None or pan is not None or not all(
            np.isfinite(metrics[k]) for k in keys):
        raise AssertionError(f"nuScenes dist_test ({name}): {metrics}")
    with open(metrics["results_path"]) as f:
        results = json.load(f)["results"]
    if sorted(results) != sorted(preds) or not all(
            len(results[t]) == len(preds[t]["scores"]) for t in preds):
        raise AssertionError(f"nuScenes dist_test ({name}): the results "
                             "json")
    log(f"nuScenes dist_test ({name}) on {card}: middle-third FPS {fps!r} "
        f"over {NUSC_FRAMES} frames of {NUSC_SWEEPS} sweeps in "
        f"{NUSC_ROWS} rows; launches {dist_launches}; every frame "
        f"bit-equal to a direct predict; " + ", ".join(
            f"{k} {metrics[k]!r}" for k in keys)
        + f"; results json with {sum(map(len, results.values()))} boxes")
    return dict(fps=fps, launches=dist_launches)


def nusc_train_step(det, cfg_path, label, card):
    """``det``'s train step at NUSC_TRAIN_BATCH on the config's train
    pipeline (:func:`timed_train_steps`: the scatter-max once a step, the
    other kernels never). -> {median_ms, peak_gib, launches}."""
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    dev = next(det.module.parameters()).device
    torch.cuda.reset_peak_memory_stats()
    ex = to_device({k: v for k, v in nusc_batch(
        cfg_path, "train", NUSC_TRAIN_BATCH).items()
        if k in det.loss_keys}, dev)
    cfg = load_config(cfg_path)
    step = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max=cfg["lr_config"]["lr_max"], total_steps=1000))
    want = {"stem": 0, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    launches, median, times, _, peak = timed_train_steps(
        det, step, ex, None, want, f"nuScenes {label} train step")
    log(f"nuScenes {label} train step, batch {NUSC_TRAIN_BATCH}, on {card}:"
        f" median {median!r} ms over {TRAIN_STEPS} steps, all {times!r};"
        f" peak memory {peak!r} GiB; launches over {TRAIN_STEPS + 1} "
        f"steps {launches}; every gradient finite, every parameter and "
        "BatchNorm statistic moved")
    return dict(median_ms=median, peak_gib=peak, launches=launches)


def nusc_train_cli(cfg_path, root, name, card, dev):
    """Two train-CLI steps of a nuScenes config at NUSC_TRAIN_BATCH with a
    checkpoint: finite loss terms, the scatter-max once a step, the other
    kernels never. -> {launches, wall_s}."""
    from partner_tpu_torch.tools import train

    work_dir = os.path.join(root, f"train_{name}")
    wall_ms, steps, cli_launches = counted(lambda: train.main([
        cfg_path, "--work_dir", work_dir, "--batch_size",
        str(NUSC_TRAIN_BATCH), "--total_steps", "2",
        "--max_steps_per_epoch", "2", "--max_points", str(NUSC_ROWS),
        "--seed", str(SEED), "--device", torch.device(dev).type]))
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ckpts = sorted(d for d in os.listdir(work_dir) if d.startswith("ckpt_"))
    if steps != 2 or ckpts[-1:] != ["ckpt_00000002"] or [
            r["step"] for r in recs] != [0, 1]:
        raise AssertionError(f"nuScenes train CLI ({name}): steps {steps}, "
                             f"checkpoints {ckpts}, records {recs}")
    if cli_launches != {"stem": 0, "scatter_max": 2, "swin_attn": 0,
                        "swin_block": 0}:
        raise AssertionError(f"nuScenes train CLI ({name}): launches "
                             f"{cli_launches}")
    for r in recs:
        vals = {k: r[k] for k in ("loss", "hm_loss", "loc_loss", "grad_norm")}
        flat = [x for v in vals.values()
                for x in (v if isinstance(v, list) else [v])]
        if not all(np.isfinite(flat)):
            raise AssertionError(f"nuScenes train CLI ({name}): {vals}")
        log(f"nuScenes train CLI ({name}) step {r['step']} on {card}: time "
            f"{r['time']!r} s, data_time {r['data_time']!r} s, loss "
            f"{r['loss']!r}, grad_norm {r['grad_norm']!r}")
    log(f"nuScenes train CLI ({name}): 2 steps at batch {NUSC_TRAIN_BATCH} "
        f"and one checkpoint in {wall_ms / 1e3!r} s")
    return dict(launches=cli_launches, wall_s=wall_ms / 1e3)


NMS_REPS = 3                 # decode + NMS calls timed alone


@torch.no_grad()
def singlehead_nms_readings(det, maps):
    """The single-head frame's decode + per-class NMS alone on its maps:
    host ms a call (median of NMS_REPS) and the fixpoint sweeps a call;
    then its parts on the card, on the score-sorted, class-shifted boxes
    the NMS built: the (N, N) suppression matrix's device ms (its rotated
    IoU in row blocks) and the fixpoint's host ms (a host read a sweep)."""
    from partner_tpu_torch.ops import nms

    times, sweeps, seen = [], [], {}
    build = nms.suppression_matrix

    def spy(*args):
        seen["args"] = args
        return build(*args)

    nms.suppression_matrix = spy   # rotated_nms looks it up at each call
    try:
        for _ in range(NMS_REPS):
            nms.sweeps = 0
            ms, _, counts = counted(lambda: det.decode(maps))
            if any(counts.values()):
                raise AssertionError(f"decode + NMS launched {counts}")
            times.append(ms)
            sweeps.append(nms.sweeps)
    finally:
        nms.suppression_matrix = build
    b, valid, _ = seen["args"]
    iou_ms = device_ms(lambda: build(*seen["args"]), reps=NMS_REPS,
                       warmup=1)
    sup = build(*seen["args"])
    fix_ms, _, _ = counted(lambda: nms._greedy_keep_upper(sup, valid))
    return dict(ms=statistics.median(times), all_ms=times,
                sweeps=sweeps[0], candidates=int(valid.sum()),
                rows=int(b.shape[0]), iou_device_ms=iou_ms,
                fixpoint_ms=fix_ms, suppressions=int(sup.sum()))


def singlehead_phase(dev, card, root, info):
    """The nuScenes single-head cylinder config
    (``voxelnet_det_cylinder_singlehead.py``: ``CenterHeadSinglePos``, one
    task of 10 classes, rectified decode, per-class NMS over every
    candidate) at full width on the synthetic 10-sweep set: its frame
    (median ms, device busy and launches, the stem and scatter-max once a
    frame, a repeat bit-equal) and its decode + NMS alone
    (:func:`singlehead_nms_readings`); the card against the CPU on
    SMALL_GRID (BEV, maps, and the kept boxes of the CPU's BEV through the
    card's RPN, head, decode and NMS); the batch-4 train step,
    ``dist_test`` over NUSC_FRAMES frames and two train-CLI steps."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    res = {}
    per_frame = {"stem": 1, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    cfg_path = write_nusc_config(root, "singlehead", info)
    cfg = load_config(cfg_path)
    dcn = load_config(NUSC_CONFIGS["dcn"])
    # the kernels see the DCN config's shapes (nusc_kernel_cases holds them)
    if (cfg["model"]["backbone"] != dcn["model"]["backbone"]
            or cfg["voxel_generator"]["range"] != dcn["voxel_generator"][
                "range"]
            or cfg["voxel_generator"]["voxel_size"] != dcn[
                "voxel_generator"]["voxel_size"]):
        raise AssertionError("single-head: another backbone or grid than "
                             "the DCN config's kernel cases")
    tc = dict(cfg["test_cfg"])
    gen = torch.Generator().manual_seed(SEED + 23)
    det = build_detector(cfg["model"], cfg["train_cfg"], tc, device=dev,
                         generator=gen)
    randomize_norms(det.module, gen)
    ex = to_device({k: v for k, v in nusc_batch(cfg_path, "val", 1).items()
                    if k in ("points", "points_mask")}, dev)
    median, times, out, tally = timed_predicts(det, ex, NUSC_TIMED,
                                               per_frame)
    busy, launches = device_busy(lambda: det.predict(ex))
    with torch.no_grad():
        maps = det.module(ex)
    task = maps["det_preds"][0]
    if sorted(task) != ["dim", "height", "hm", "reg", "rot", "vel"] or not \
            all(torch.isfinite(v).all() for v in task.values()):
        raise AssertionError(f"single-head maps {sorted(task)}")
    kept = check_detections(out, tc, box_dim=9)
    if not identical(det.predict(ex), out):
        raise AssertionError("single-head: a repeat differs")
    nms_r = singlehead_nms_readings(det, maps)
    log(f"nuScenes single-head frame on {card}: {tuple(ex['points'].shape)} "
        f"point rows, median {median!r} ms over {NUSC_TIMED} frames (host "
        f"clock around a synchronized predict), all {times!r}; device busy "
        f"{busy!r} ms and {launches!r} launches a frame; kernel launches "
        f"{tally}; hm {tuple(task['hm'].shape)}; {kept} boxes kept of "
        f"{nms_r['candidates']} candidates ({nms_r['rows']} rows) by the "
        f"per-class NMS; repeat bit-equal; decode + NMS alone "
        f"{nms_r['ms']!r} ms (all {nms_r['all_ms']!r}), {nms_r['sweeps']} "
        f"fixpoint sweeps (a host read each); the suppression matrix "
        f"{nms_r['iou_device_ms']!r} ms device time ({nms_r['rows']}^2 "
        f"pairs, {nms_r['suppressions']} suppressing), the fixpoint "
        f"{nms_r['fixpoint_ms']!r} ms host clock")
    res["frame"] = dict(median_ms=median, device_busy_ms=busy,
                        launches_per_frame=launches, launches=tally,
                        kept=kept, nms=nms_r)
    del maps, out, ex, task

    # ---- card against CPU on SMALL_GRID, kept boxes too
    gdet, cdet, bev = centerpoint_reference(
        dev, card, NUSC_SINGLEHEAD, "nuScenes single-head", SEED + 24,
        REF_F32)
    with torch.no_grad():
        got = gdet.decode(gdet.module.bbox_head(gdet.module.neck(
            bev.to(dev))))
        want = cdet.decode(cdet.module.bbox_head(cdet.module.neck(bev)))
    at_place = same_detections(got, want)
    log(f"nuScenes single-head kept detections on SMALL_GRID {SMALL_GRID}, "
        f"the CPU's BEV through each side's RPN, head, rectified decode and "
        f"per-class NMS: {len(kept_boxes(want)['scores'])} each, {at_place} "
        f"equal at their place, the rest within a score tie of {PP_TIE}")
    del gdet, cdet, bev, got, want

    res["train"] = nusc_train_step(det, cfg_path, "single-head", card)
    res["dist_test"] = nusc_dist_test(det, cfg_path, root, "singlehead",
                                      card, per_frame)
    del det
    torch.cuda.empty_cache()
    res["train_cli"] = nusc_train_cli(cfg_path, root, "singlehead", card,
                                      dev)
    log(f"nuScenes single-head: {time.perf_counter() - t0:.1f} s in all")
    return res


# ------------------------------------------------------------ PointPillars

PP_DIR = os.path.join(ROOT, "configs", "waymo", "pp")
PP_CONFIGS = {
    "three_class": os.path.join(PP_DIR,
                                "waymo_centerpoint_pp_two_pfn_stride1_3x.py"),
    "two_class": os.path.join(
        PP_DIR, "waymo_centerpoint_pp_two_cls_two_pfn_stride1_3x.py")}
PP_TWO_STAGE_CONFIGS = {
    "three_class": os.path.join(
        PP_DIR, "two_stage",
        "waymo_centerpoint_pp_two_pfn_stride1_two_stage_bev_6epoch.py"),
    "two_class": os.path.join(
        PP_DIR, "two_stage", "waymo_centerpoint_pp_two_cls_two_pfn_stride1_"
        "two_stage_bev_6epoch.py")}
PP_CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")   # the configs' names
PP_EVAL_FRAMES = 8           # dist_test frames on disk (cut first)
PP_SMALL_GRID = 128          # the reference's pillar grid, 128 x 128
PP_REF_TOL = 1e-5            # float32 both sides: summation order only
PP_TIE = 1e-6                # scores closer than this may swap places


def pp_cfgs(config=PP_CONFIGS["three_class"], grid=None):
    """(model cfg, train cfg, test cfg) of a PointPillars config (or a
    two-stage one, its first stage) with ``score_threshold`` 0 (as
    :func:`frame_cfgs`), optionally on a ``grid`` x ``grid`` pillar grid
    (same widths, the reader's cell too)."""
    import copy

    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(config)
    m = copy.deepcopy(cfg["model"])
    tc = copy.deepcopy(cfg["test_cfg"])
    tc["score_threshold"] = 0.0
    if grid is not None:
        first = m.get("first_stage_cfg", m)
        vg = first["bbox_head"]["voxel_generator"]
        r = vg["range"]
        vg["voxel_size"] = [(r[3] - r[0]) / grid, (r[4] - r[1]) / grid,
                            vg["voxel_size"][2]]
        first["reader"] = dict(first["reader"],
                               voxel_size=tuple(vg["voxel_size"]))
    return m, copy.deepcopy(cfg["train_cfg"]), tc


def polar_extent(pc_range):
    """A cartesian range as the (rho, phi, z) extent :func:`synthetic_scene`
    draws from: rho up to the half-width, every azimuth."""
    return (0.0, -np.pi, pc_range[2], pc_range[3], np.pi, pc_range[5])


def cuboid_sweep(rng, pc_range, n_points, rows=None):
    """bench.py's sweep (:func:`synthetic_sweep`: log-uniform range from 1 m
    to the grid's half-width, ground-hugging z, every azimuth) in the
    cuboid layout a PointPillars config's pipeline gives, [x, y, z,
    intensity, elongation, rho, phi], padded to ``rows`` (1.2x)."""
    pts, mask = synthetic_sweep(rng, (1.0, -np.pi, pc_range[2],
                                      pc_range[3], np.pi, pc_range[5]),
                                n_points)
    rho, phi, z, x, y, i, e = (pts[0, :n_points, k] for k in range(7))
    rows = rows or pts.shape[1]
    out = np.zeros((1, rows, 7), np.float32)
    out[0, :n_points] = np.stack([x, y, z, i, e, rho, phi], 1)
    mask = np.zeros((1, rows), bool)
    mask[0, :n_points] = True
    return out, mask


def pp_train_example(rng, model_cfg, train_cfg, batch, n_points, rows,
                     max_boxes):
    """A PointPillars train batch made with numpy and the port's
    ``CenterTargetAssigner`` (what ``AssignLabel`` gives the CLI): per
    sample a :func:`synthetic_scene` over the cartesian range whose boxes
    take the config's classes in turn and a random velocity, in the cuboid
    layout [x, y, z, intensity, elongation, rho, phi], padded to ``rows``;
    per task ``hm`` (B, ny, nx, C), ``anno_box``, ``ind``, ``mask`` and
    ``cat``."""
    from partner_tpu_torch.core.targets import CenterTargetAssigner

    bh = model_cfg["bbox_head"]
    vg = bh["voxel_generator"]
    pr = vg["range"]
    grid = [int(round((pr[3 + i] - pr[i]) / vg["voxel_size"][i]))
            for i in range(3)]
    a = train_cfg["assigner"]
    assigner = CenterTargetAssigner(
        bh["tasks"], a["out_size_factor"], a["gaussian_overlap"],
        a["max_objs"], a["min_radius"], a["voxel_shape"])
    n_cls = sum(len(t["class_names"]) for t in bh["tasks"])
    pts = np.zeros((batch, rows, 7), np.float32)
    mask = np.zeros((batch, rows), bool)
    targets = []
    for i in range(batch):
        boxes, xyz = synthetic_scene(rng, polar_extent(pr), n_points,
                                     max_boxes)
        pts[i, :n_points] = np.concatenate(
            [xyz, rng.rand(n_points, 2), np.hypot(xyz[:, :1], xyz[:, 1:2]),
             np.arctan2(xyz[:, 1:2], xyz[:, :1])], 1)
        mask[i, :n_points] = True
        gt = np.concatenate([boxes[:, :6], rng.randn(len(boxes), 2),
                             boxes[:, 6:]], 1).astype(np.float32)
        targets.append(assigner.assign(gt, np.arange(len(gt)) % n_cls + 1,
                                       grid, vg["voxel_size"], pr))
    ex = {"points": pts, "points_mask": mask}
    for k in ("hm", "anno_box", "ind", "mask", "cat"):
        ex[k] = [np.stack([t[k][j] for t in targets])
                 for j in range(len(bh["tasks"]))]
    ex["hm"] = [h.transpose(0, 2, 3, 1) for h in ex["hm"]]   # NHWC
    return ex


@torch.no_grad()
def randomize_pfn(module, gen):
    """Draw the pillar encoder's ``MaskedBatchNorm`` scales and biases
    (:func:`randomize_norms` draws the norms it knows and every
    statistic)."""
    for name, t in module.reader.named_parameters():
        if name.endswith("_bn.scale"):
            t.copy_(0.5 + torch.rand(t.shape, generator=gen))
        elif name.endswith("_bn.bias"):
            t.copy_(0.2 * torch.randn(t.shape, generator=gen))


@torch.no_grad()
def pillar_census(module, ex):
    """(cells the sweep occupies, pillars kept, valid points in a dropped
    pillar) of sample 0 on the module's pillar grid, each row's cell taken
    as ``dynamic_voxelize`` takes it."""
    vox = module.pillarize(ex["points"][:1], ex["points_mask"][:1])
    dev = ex["points"].device
    nx, ny = module.grid_size[:2]
    pr = module.pc_range
    size = torch.tensor([module.voxel_size[0], module.voxel_size[1],
                         pr[5] - pr[2]], dtype=torch.float32, device=dev)
    lo = torch.tensor(pr[:3], dtype=torch.float32, device=dev)
    co = torch.floor((ex["points"][0, :, :3] - lo) / size).long()
    lim = torch.tensor([nx, ny, 1], device=dev)
    ok = ex["points_mask"][0] & ((co >= 0) & (co < lim)).all(1)
    occupied = int(torch.unique(co[ok, 1] * nx + co[ok, 0]).numel())
    dropped = int((ok & (vox["point_voxel"][0] >= module.max_pillars)).sum())
    return occupied, int(vox["mask"].sum()), dropped


def write_pp_config(root, config, info_path, pretrained=None):
    """A PointPillars config file with ``score_threshold`` 0 (as
    :func:`pp_cfgs`), ``data.train`` / ``data.val`` at ``info_path``, and
    a metrics record every step; the train pipeline's rotation, scaling
    and shuffle as the config has them; a two-stage config's first stage
    ``pretrained`` at ``pretrained``."""
    path = os.path.join(root, os.path.basename(config))
    with open(path, "w") as f:
        f.write(f"__file__ = {config!r}\n"
                f"exec(open({config!r}).read())\n"
                + (f"model['first_stage_cfg']['pretrained'] = "
                   f"{pretrained!r}\n" if pretrained else "")
                + "test_cfg['score_threshold'] = 0.0\n"
                "for _s in ('train', 'val'):\n"
                f"    data[_s].update(info_path={info_path!r}, "
                f"root_path={root!r})\n"
                "log_config = dict(interval=1, hooks=[dict(type="
                "'TextLoggerHook'), dict(type='MetricsSinkHook')])\n")
    return path


def same_detections(got, want, tie=PP_TIE, box_tol=1e-4, tie_scores=None):
    """Sample 0's kept detections of two ``predict`` outputs: the same
    count and labels, and each row within ``box_tol`` of the other's row
    at its place or, where scores tie within ``tie``, of a row of that
    tie -> rows equal at their place. ``tie_scores`` are the scores that
    ordered the kept rows where those are not ``want``'s own (a two-stage
    detector's first-stage scores)."""
    g, w = kept_boxes(got), kept_boxes(want)
    n = len(w["scores"])
    ws = w["scores"] if tie_scores is None else tie_scores
    if len(g["scores"]) != n or len(ws) != n:
        raise AssertionError(f"kept {len(g['scores'])} != {n}")
    at_place = 0
    for i in range(n):
        near = np.flatnonzero(np.abs(ws - ws[i]) <= tie)
        ok = [k for k in near if g["label_preds"][i] == w["label_preds"][k]
              and np.abs(g["box3d_lidar"][i] - w["box3d_lidar"][k]).max()
              <= box_tol]
        if not ok:
            raise AssertionError(f"kept row {i} matches no row of its tie")
        at_place += int(i in ok and abs(g["scores"][i] - w["scores"][i])
                        <= 1e-6)
    return at_place


@torch.no_grad()
def pp_reference(dev, card):
    """The 3-class config's widths on a PP_SMALL_GRID pillar grid, same
    weights and points: the canvas, the RPN output and each head map of
    the card against the CPU (both float32), each stage fed the CPU's
    input, then the kept detections of ``predict`` on both."""
    from partner_tpu_torch.models import build_detector

    m, _, tc = pp_cfgs(grid=PP_SMALL_GRID)
    gen = torch.Generator().manual_seed(SEED + 31)
    gpu = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(gpu.module, gen)
    randomize_pfn(gpu.module, gen)
    cpu = build_detector(m, None, tc, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                gpu.module.state_dict().items()})
    pts, mask = cuboid_sweep(np.random.RandomState(SEED + 31),
                             m["bbox_head"]["voxel_generator"]["range"],
                             30_000)
    exc = to_device({"points": pts, "points_mask": mask}, "cpu")
    exg = to_device({"points": pts, "points_mask": mask}, dev)
    canvas = cpu.module.encode_canvas(exc["points"], exc["points_mask"])
    rel_rms(f"PointPillars canvas on {card}", gpu.module.encode_canvas(
        exg["points"], exg["points_mask"]), canvas, PP_REF_TOL)
    x = cpu.module.neck(canvas)
    rel_rms("PointPillars RPN", gpu.module.neck(canvas.to(dev)), x,
            PP_REF_TOL)
    want = cpu.module.bbox_head(x)["det_preds"][0]
    got = gpu.module.bbox_head(x.to(dev))["det_preds"][0]
    for k in sorted(want):
        rel_rms(f"PointPillars head {k}", got[k], want[k], PP_REF_TOL)
    at_place = same_detections(gpu.predict(exg), cpu.predict(exc))
    kept = int(cpu.predict(exc)["mask"].sum())
    log(f"PointPillars kept detections on {PP_SMALL_GRID} x {PP_SMALL_GRID}"
        f" pillars, card against CPU: {kept} each, {at_place} equal at "
        f"their place, the rest within a score tie of {PP_TIE}")


def pp_phase(dev, card):
    """The two Waymo PointPillars configs at full width: each frame on a
    cuboid 180,000-point sweep (median ms, device busy and launches, kept
    boxes, finite maps, a repeat bit-equal, pillars against the capacity);
    the card against the CPU on a small pillar grid; for the 3-class
    config the batch-4 train step, ``dist_test`` from a port checkpoint
    bit-equal to direct predicts, and two train-CLI steps. No hand kernel
    lies on this path: every launch count stays 0."""
    import pickle
    import tempfile

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.tools import dist_test, train
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    res = {}
    none = dict.fromkeys(kernel_wrappers(), 0)
    dets = {}
    for name, config in PP_CONFIGS.items():
        m, train_cfg, tc = pp_cfgs(config)
        gen = torch.Generator().manual_seed(SEED + 30)
        t0 = time.perf_counter()
        det = build_detector(m, None, tc, device=dev, generator=gen)
        randomize_norms(det.module, gen)
        randomize_pfn(det.module, gen)
        n_params = sum(p.numel() for p in det.module.parameters())
        log(f"PointPillars {name}: grid {det.module.grid_size}, capacity "
            f"{det.module.max_pillars} pillars, {n_params} params, built in "
            f"{time.perf_counter() - t0:.1f} s")
        pr = m["bbox_head"]["voxel_generator"]["range"]
        pts, mask = cuboid_sweep(np.random.RandomState(SEED + 30), pr,
                                 N_POINTS)
        ex = to_device({"points": pts, "points_mask": mask}, dev)
        occupied, kept_pillars, dropped = pillar_census(det.module, ex)
        median, times, out, tally = timed_predicts(det, ex, FRAMES, none)
        busy, launches = device_busy(lambda: det.predict(ex))
        with torch.no_grad():
            maps = det.module(ex)["det_preds"][0]
        if not all(torch.isfinite(v).all() for v in maps.values()):
            raise AssertionError(f"PointPillars {name}: non-finite maps")
        kept = check_detections(out, tc)
        if not identical(det.predict(ex), out):
            raise AssertionError(f"PointPillars {name}: a repeat differs")
        log(f"PointPillars {name} frame on {card}: {N_POINTS} cuboid points "
            f"in {pts.shape[1]} rows, median {median!r} ms over {FRAMES} "
            f"frames (host clock around a synchronized predict), all "
            f"{times!r}; device busy {busy!r} ms and {launches!r} launches "
            f"a frame; kernel launches {tally}; pillars: {occupied} cells "
            f"occupied, {kept_pillars} kept of {det.module.max_pillars}, "
            f"{dropped} points in dropped pillars; {kept} boxes kept; maps "
            f"{sorted(maps)} finite; repeat bit-equal")
        res[name] = dict(median_ms=median, device_busy_ms=busy,
                         launches_per_frame=launches, launches=tally,
                         kept=kept, occupied=occupied,
                         pillars=kept_pillars, dropped_points=dropped,
                         capacity=det.module.max_pillars)
        dets[name] = (det, m, train_cfg, tc)
        del maps, out, ex
        torch.cuda.empty_cache()
    del dets["two_class"]

    pp_reference(dev, card)

    # ---- the 3-class train step at batch 4
    det, m, train_cfg, tc = dets.pop("three_class")
    cfg = load_config(PP_CONFIGS["three_class"])
    batch = cfg["data"]["samples_per_gpu"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ex = to_device(pp_train_example(
        np.random.RandomState(SEED + 32), m, train_cfg, batch, TRAIN_POINTS,
        TRAIN_ROWS, MAX_BOXES), dev)
    log(f"PointPillars train batch: {batch} samples of {TRAIN_POINTS} "
        f"points in {TRAIN_ROWS} rows, "
        f"{[int(t.sum()) for t in ex['mask'][0]]} center targets")
    stats = {k: v.clone() for k, v in det.module.reader.state_dict().items()
             if k.endswith(("_bn.mean", "_bn.var"))}
    step = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max=cfg["lr_config"]["lr_max"], total_steps=1000))
    launches, median, times, _, peak = timed_train_steps(
        det, step, ex, None, none, "PointPillars train step")
    after = det.module.reader.state_dict()
    still = [k for k, v in stats.items() if torch.equal(v, after[k])]
    if still:
        raise AssertionError(f"PointPillars train: PFN statistics {still} "
                             "unchanged")
    log(f"PointPillars train step, batch {batch}, on {card}: median "
        f"{median!r} ms over {TRAIN_STEPS} steps, all {times!r}; peak "
        f"memory {peak!r} GiB; launches over {TRAIN_STEPS + 1} steps "
        f"{launches}; every gradient finite, every parameter, BatchNorm "
        "statistic and PFN statistic moved")
    res["train"] = dict(median_ms=median, peak_gib=peak, launches=launches)
    del step, ex
    torch.cuda.empty_cache()

    # ---- dist_test from a port checkpoint and two train-CLI steps
    with tempfile.TemporaryDirectory() as root:
        pr = m["bbox_head"]["voxel_generator"]["range"]
        info = write_val_set(root, np.random.RandomState(SEED + 33),
                             polar_extent(pr), PP_EVAL_FRAMES,
                             names=PP_CLASSES)
        cfg_path = write_pp_config(root, PP_CONFIGS["three_class"], info)
        save_checkpoint(os.path.join(root, "ckpt"), 0,
                        det.module.state_dict())
        work_dir = os.path.join(root, "eval")
        _, ((metrics, _), fps), dist_launches = counted(
            lambda: dist_test.main([
                cfg_path, "--checkpoint",
                os.path.join(root, "ckpt", "latest"), "--work_dir", work_dir,
                "--max_points", str(EVAL_ROWS), "--device",
                torch.device(dev).type]))
        with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
            preds = pickle.load(f)
        direct = {}
        for b in DataLoader(build_dataset(dict(load_config(cfg_path)[
                "data"]["val"])), 1, shuffle=False, max_points=EVAL_ROWS):
            e = to_device({k: b[k] for k in ("points", "points_mask")}, dev)
            direct[b["metadata"][0]["token"]] = kept_boxes(det.predict(e))
        if dist_launches != none:
            raise AssertionError(f"PointPillars dist_test: launches "
                                 f"{dist_launches}")
        if sorted(preds) != sorted(direct) or not all(
                np.array_equal(preds[t][k], direct[t][k])
                for t in direct for k in direct[t]):
            raise AssertionError("PointPillars dist_test: a frame differs "
                                 "from a direct predict")
        keys = [f"AP/L1/{c}" for c in PP_CLASSES] + ["mAP/L1", "mAPH/L2"]
        if not all(k in metrics and np.isfinite(metrics[k]) for k in keys):
            raise AssertionError(f"PointPillars dist_test: {metrics}")
        log(f"PointPillars dist_test (three_class) on {card}: middle-third "
            f"FPS {fps!r} over {PP_EVAL_FRAMES} frames of {N_POINTS} points "
            f"in {EVAL_ROWS} rows; launches {dist_launches}; every frame "
            "bit-equal to a direct predict; " + ", ".join(
                f"{k} {metrics[k]!r}" for k in keys))
        res["dist_test"] = dict(fps=fps, launches=dist_launches)
        del det
        torch.cuda.empty_cache()

        work_dir = os.path.join(root, "train")
        wall_ms, steps, cli_launches = counted(lambda: train.main([
            cfg_path, "--work_dir", work_dir, "--batch_size", str(batch),
            "--total_steps", "2", "--max_steps_per_epoch", "2",
            "--max_points", str(TRAIN_ROWS), "--seed", str(SEED),
            "--device", torch.device(dev).type]))
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ckpts = sorted(d for d in os.listdir(work_dir)
                       if d.startswith("ckpt_"))
    if steps != 2 or ckpts[-1:] != ["ckpt_00000002"] or [
            r["step"] for r in recs] != [0, 1]:
        raise AssertionError(f"PointPillars train CLI: steps {steps}, "
                             f"checkpoints {ckpts}, records {recs}")
    if cli_launches != none:
        raise AssertionError(f"PointPillars train CLI: launches "
                             f"{cli_launches}")
    for r in recs:
        vals = {k: r[k] for k in ("loss", "hm_loss", "loc_loss", "grad_norm")}
        flat = [x for v in vals.values()
                for x in (v if isinstance(v, list) else [v])]
        if not all(np.isfinite(flat)):
            raise AssertionError(f"PointPillars train CLI: {vals}")
        log(f"PointPillars train CLI step {r['step']} on {card}: time "
            f"{r['time']!r} s, data_time {r['data_time']!r} s, {vals}")
    res["train_cli"] = dict(launches=cli_launches, wall_s=wall_ms / 1e3)
    log(f"PointPillars train CLI: 2 steps at batch {batch} and one "
        f"checkpoint in {wall_ms / 1e3!r} s")
    res["two_stage"] = pp_two_stage_phase(dev, card)
    log(f"PointPillars phase {time.perf_counter() - t_phase:.1f} s in all")
    return res


@torch.no_grad()
def pp_two_stage_reference(dev, card):
    """The 3-class two-stage config's widths on a PP_SMALL_GRID pillar
    grid, same weights and points: the neck map the RoI head samples, the
    refine stage's IoU logits and residuals on the CPU's proposals, and
    the kept detections of ``predict``, the card against the CPU (both
    float32)."""
    from partner_tpu_torch.models import build_detector

    m, _, tc = pp_cfgs(PP_TWO_STAGE_CONFIGS["three_class"],
                       grid=PP_SMALL_GRID)
    gen = torch.Generator().manual_seed(SEED + 41)
    gpu = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(gpu.module, gen)
    randomize_pfn(gpu.module.first, gen)
    cpu = build_detector(m, None, tc, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                gpu.module.state_dict().items()})
    pr = m["first_stage_cfg"]["bbox_head"]["voxel_generator"]["range"]
    pts, mask = cuboid_sweep(np.random.RandomState(SEED + 41), pr, 30_000)
    exc = to_device({"points": pts, "points_mask": mask}, "cpu")
    exg = to_device({"points": pts, "points_mask": mask}, dev)
    preds, bev = cpu.module(exc)
    rel_rms(f"PointPillars two-stage neck map on {card}",
            gpu.module(exg)[1], bev, PP_REF_TOL)
    boxes, scores = cpu.decode_proposals(preds["det_preds"][0])
    from partner_tpu_torch.models.center_head import center_head_post_process

    post = center_head_post_process(boxes, scores, cpu.test_cfg)
    props = torch.cat([post["box3d_lidar"][..., :6],
                       post["box3d_lidar"][..., -1:]], -1)
    want = cpu.module.refine(bev, props, post["scores"])
    got = gpu.module.refine(bev.to(dev), props.to(dev),
                            post["scores"].to(dev))
    for name, g, w in zip(("IoU logits", "residuals"), got, want):
        rel_rms(f"PointPillars refine {name}", g, w, PP_REF_TOL)
    # the kept rows follow the first stage's scores, not the refined ones
    first = kept_boxes(cpu.first_driver.predict(exc))["scores"]
    at_place = same_detections(gpu.predict(exg), cpu.predict(exc),
                               tie_scores=first)
    log(f"PointPillars two-stage kept detections on {PP_SMALL_GRID} x "
        f"{PP_SMALL_GRID} pillars, card against CPU: {len(first)} each, "
        f"{at_place} equal at their place, the rest within a first-stage "
        f"score tie of {PP_TIE}")


def pp_two_stage_phase(dev, card):
    """The Waymo PointPillars two-stage configs at full width (the frozen
    one-stage PointPillars, 500 proposals a frame, 5 samples each on the
    468 x 468 x 384 neck map, the RoI head 1921 -> 256 -> 256): the 3-class
    frame taking turns with its first stage's one-stage frame (median ms,
    device busy and launches, the refine stage's device ms and launches,
    kept boxes, a repeat bit-equal); the card against the CPU on a small
    pillar grid (:func:`pp_two_stage_reference`); the frozen train step at
    batch 4 with its first stage loaded from a seeded port one-stage
    checkpoint this phase writes (planted positive proposals; the first
    stage bit-unchanged, every RoI parameter moved); two train-CLI steps
    from that checkpoint through ``pretrained`` and ``dist_test`` from the
    CLI's checkpoint, each frame bit-equal to a direct ``predict``; the
    2-class frame. No hand kernel lies on this path: every launch count
    stays 0."""
    import pickle
    import tempfile

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.models.center_head import center_head_post_process
    from partner_tpu_torch.tools import dist_test, train
    from partner_tpu_torch.tools.train import load_pretrained_first_stage
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    res = {}
    none = dict.fromkeys(kernel_wrappers(), 0)
    m, train_cfg, tc = pp_cfgs(PP_TWO_STAGE_CONFIGS["three_class"])
    gen = torch.Generator().manual_seed(SEED + 40)
    det = build_detector(m, train_cfg, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    randomize_pfn(det.module.first, gen)
    head = det.module.roi_head
    log(f"PointPillars two-stage detector: first stage grid "
        f"{det.module.first.grid_size} at stride "
        f"{det.module.first.out_size_factor}, RoI head "
        f"{head.Dense_0.weight.shape[1]} -> {head.Dense_0.weight.shape[0]} "
        f"-> {head.Dense_1.weight.shape[0]}, "
        f"{sum(p.numel() for p in det.module.parameters())} params, frozen "
        f"first stage; built in {time.perf_counter() - t0:.1f} s")
    pr = m["first_stage_cfg"]["bbox_head"]["voxel_generator"]["range"]
    pts, mask = cuboid_sweep(np.random.RandomState(SEED + 30), pr, N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)

    # ---- the frame, taking turns with the one-stage frame (same weights)
    runs = {"two-stage": lambda: det.predict(ex),
            "one-stage": lambda: det.first_driver.predict(ex)}
    times = {k: [] for k in runs}
    tally = dict(none)
    for i in range(TS_FRAMES + 1):
        for name, run in runs.items():
            ms, out, counts = counted(run)
            if counts != none:
                raise AssertionError(f"PointPillars {name} frame {i}: "
                                     f"launches {counts}")
            if i:
                times[name].append(ms)
    out = det.predict(ex)
    if not identical(det.predict(ex), out):
        raise AssertionError("PointPillars two-stage frame: a repeat differs")
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
        _, _, refine_counts = counted(refine)
        refine_busy = device_busy(refine)
    if refine_counts != none:
        raise AssertionError(f"PointPillars refine: launches {refine_counts}")
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"PointPillars two-stage frame on {card}: median "
        f"{med['two-stage']!r} ms against the one-stage frame's "
        f"{med['one-stage']!r} on the same first stage, taking turns over "
        f"{TS_FRAMES} frames each (host clock around a synchronized "
        f"predict), all {times!r}; device busy and launches a frame "
        f"{busy!r} (torch.profiler, 1 frame); the refine stage "
        f"({tuple(bev.shape)} neck map, {props7.shape[1]} proposals x 5 "
        f"points) {refine_ms!r} ms device time (CUDA events), "
        f"{refine_busy!r} (busy ms, launches); kernel launches {tally}; "
        f"{kept} boxes kept; a repeat bit-equal")
    res["frame"] = dict(median_ms=med["two-stage"],
                        one_stage_median_ms=med["one-stage"],
                        device_busy_ms=busy["two-stage"][0],
                        launches_per_frame=busy["two-stage"][1],
                        refine_ms=refine_ms, refine_launches=refine_busy[1],
                        refine_busy_ms=refine_busy[0], launches=tally,
                        kept=kept)
    del det, preds, bev, boxes, scores, post, out, runs, ex
    torch.cuda.empty_cache()

    pp_two_stage_reference(dev, card)

    with tempfile.TemporaryDirectory() as root:
        # ---- a seeded one-stage checkpoint, the frozen step from it
        gen = torch.Generator().manual_seed(SEED + 42)
        one = build_detector(m["first_stage_cfg"], None, tc, device=dev,
                             generator=gen)
        randomize_norms(one.module, gen)
        randomize_pfn(one.module, gen)
        pretrained = os.path.join(root, "one_stage", "latest")
        save_checkpoint(os.path.dirname(pretrained), 0,
                        one.module.state_dict())
        del one
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        det = build_detector(m, train_cfg, tc, device=dev,
                             generator=torch.Generator().manual_seed(SEED))
        load_pretrained_first_stage(det, pretrained)
        batch = load_config(PP_TWO_STAGE_CONFIGS["three_class"])["data"][
            "samples_per_gpu"]
        ex = pp_train_example(np.random.RandomState(SEED + 43),
                              m["first_stage_cfg"], train_cfg, batch,
                              TRAIN_POINTS, TRAIN_ROWS, MAX_BOXES)
        ex["global_box"] = np.zeros((batch, MAX_BOXES, 10), np.float32)
        ex = to_device({k: v for k, v in plant_positives(det, ex, dev).items()
                        if k in det.loss_keys}, dev)
        opt = build_one_cycle_optimizer(det.module, lr_max=3e-3,
                                        total_steps=1000)
        step = make_train_step(det, opt)
        before = {k: v.detach().clone() for k, v in
                  det.module.state_dict().items()}
        times, launches = [], dict(none)
        for i in range(TRAIN_STEPS + 1):
            ms, met, counts = counted(lambda: step(ex, None))
            if counts != none:
                raise AssertionError(f"PointPillars frozen step {i}: "
                                     f"launches {counts}")
            vals = {k: float(v) for k, v in met.items()}
            log(f"PointPillars two-stage frozen step {i}: {ms!r} ms, {vals}")
            if not all(np.isfinite(list(vals.values()))) or not (
                    vals["roi_reg_loss"] > 0):
                raise AssertionError(f"PointPillars frozen step {i}: {vals}")
            if i:
                times.append(ms)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        after = det.module.state_dict()
        moved_first = [k for k in after if k.startswith("first.")
                       and not torch.equal(after[k], before[k])]
        still_roi = [k for k in after if k.startswith("roi_head.")
                     and torch.equal(after[k], before[k])]
        if moved_first or still_roi or len(opt.params) != 12:
            raise AssertionError(f"PointPillars frozen step: first stage "
                                 f"moved {moved_first[:5]}, RoI unchanged "
                                 f"{still_roi}")
        median = statistics.median(times)
        log(f"PointPillars two-stage frozen train step, batch {batch} "
            f"({TRAIN_POINTS} points a sample in {TRAIN_ROWS} rows), first "
            f"stage from a port one-stage checkpoint, on {card}: median "
            f"{median!r} ms over {TRAIN_STEPS} steps (host clock around a "
            f"synchronized step), all {times!r}; peak memory {peak!r} GiB; "
            f"launches over {TRAIN_STEPS + 1} steps {launches}; the first "
            "stage's parameters and statistics (the PFN's among them) "
            "bit-unchanged, every RoI parameter moved")
        res["train"] = dict(median_ms=median, peak_gib=peak,
                            launches=launches)
        del det, opt, step, ex, before, after
        torch.cuda.empty_cache()

        # ---- two train-CLI steps through ``pretrained``, then dist_test
        info = write_val_set(root, np.random.RandomState(SEED + 44),
                             polar_extent(pr), PP_EVAL_FRAMES,
                             names=PP_CLASSES)
        cfg_path = write_pp_config(root, PP_TWO_STAGE_CONFIGS["three_class"],
                                   info, pretrained=pretrained)
        work_dir = os.path.join(root, "train")
        wall_ms, steps, cli_launches = counted(lambda: train.main([
            cfg_path, "--work_dir", work_dir, "--batch_size", str(batch),
            "--total_steps", "2", "--max_steps_per_epoch", "2",
            "--max_points", str(TRAIN_ROWS), "--seed", str(SEED),
            "--device", torch.device(dev).type]))
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if steps != 2 or [r["step"] for r in recs] != [0, 1] or (
                cli_launches != none):
            raise AssertionError(f"PointPillars two-stage train CLI: steps "
                                 f"{steps}, records {recs}, launches "
                                 f"{cli_launches}")
        for r in recs:
            vals = {k: r[k] for k in ("loss", "roi_cls_loss", "roi_reg_loss",
                                      "grad_norm")}
            log(f"PointPillars two-stage train CLI step {r['step']} on "
                f"{card}: time {r['time']!r} s, data_time "
                f"{r['data_time']!r} s, {vals}")
            if not all(np.isfinite(list(vals.values()))):
                raise AssertionError(f"PointPillars two-stage CLI: {vals}")
        ckpt = os.path.join(work_dir, "latest")
        payload = load_checkpoint(ckpt)[0]
        pre = load_checkpoint(pretrained)[0]["state_dict"]
        moved = [k for k in pre if not torch.equal(
            payload["state_dict"]["first." + k], pre[k])]
        if moved or sorted(payload["opt_state"]["mu"]) != sorted(
                k for k in payload["state_dict"] if k.startswith("roi_head.")):
            raise AssertionError(f"PointPillars two-stage CLI: first stage "
                                 f"moved {moved[:5]} or Adam state not the "
                                 "RoI head's")
        log(f"PointPillars two-stage train CLI: 2 steps at batch {batch} from "
            f"the pretrained one-stage checkpoint in {wall_ms / 1e3!r} s "
            f"(build, load, data, steps, checkpoints); launches "
            f"{cli_launches}; the first stage bit-equal to the checkpoint's, "
            "Adam moments the RoI head's alone")
        res["train_cli"] = dict(launches=cli_launches, wall_s=wall_ms / 1e3)

        _, ((metrics, _), fps), eval_launches = counted(
            lambda: dist_test.main([
                cfg_path, "--checkpoint", ckpt, "--work_dir",
                os.path.join(root, "eval"), "--max_points", str(EVAL_ROWS),
                "--device", torch.device(dev).type]))
        if eval_launches != none:
            raise AssertionError(f"PointPillars two-stage dist_test: "
                                 f"launches {eval_launches}")
        with open(os.path.join(root, "eval", "prediction.pkl"), "rb") as f:
            preds = pickle.load(f)
        cfg = load_config(cfg_path)
        det = build_detector(cfg["model"], None, cfg["test_cfg"], device=dev)
        det.module.load_state_dict(payload["state_dict"])
        direct = {}
        for b in DataLoader(build_dataset(dict(cfg["data"]["val"])), 1,
                            shuffle=False, max_points=EVAL_ROWS):
            e = to_device({k: b[k] for k in ("points", "points_mask")}, dev)
            direct[b["metadata"][0]["token"]] = kept_boxes(det.predict(e))
        if sorted(preds) != sorted(direct) or not all(
                np.array_equal(preds[t][k], direct[t][k])
                for t in direct for k in direct[t]):
            raise AssertionError("PointPillars two-stage dist_test: a frame "
                                 "differs from a direct predict")
        keys = [f"AP/L1/{c}" for c in PP_CLASSES] + ["mAP/L1", "mAPH/L2"]
        if not all(k in metrics and np.isfinite(metrics[k]) for k in keys):
            raise AssertionError(f"PointPillars two-stage dist_test: "
                                 f"{metrics}")
        log(f"PointPillars two-stage dist_test on {card}: middle-third FPS "
            f"{fps!r} over {PP_EVAL_FRAMES} frames of {N_POINTS} points in "
            f"{EVAL_ROWS} rows; launches {eval_launches}; every frame "
            "bit-equal to a direct predict; " + ", ".join(
                f"{k} {metrics[k]!r}" for k in keys))
        res["dist_test"] = dict(fps=fps, launches=eval_launches)
        del det
        torch.cuda.empty_cache()

    # ---- the 2-class frame
    m2, _, tc2 = pp_cfgs(PP_TWO_STAGE_CONFIGS["two_class"])
    gen = torch.Generator().manual_seed(SEED + 45)
    det = build_detector(m2, None, tc2, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    randomize_pfn(det.module.first, gen)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    median, times, out, tally = timed_predicts(det, ex, TS_FRAMES, none)
    kept = check_detections(out, tc2)
    if int(out["label_preds"][0][out["mask"][0]].max()) > 1:
        raise AssertionError("PointPillars two-stage 2-class: a third label")
    log(f"PointPillars two-stage 2-class frame on {card}: median {median!r} "
        f"ms over {TS_FRAMES} frames, all {times!r}; launches {tally}; "
        f"{kept} boxes kept, labels of 2 classes")
    res["two_class"] = dict(median_ms=median, launches=tally, kept=kept)
    del det, ex, out
    torch.cuda.empty_cache()
    log(f"PointPillars two-stage: {time.perf_counter() - t0:.1f} s in all")
    return res


# ------------------------------------------------------------ PolarStream

POLAR_DIR = os.path.join(ROOT, "configs", "nusc", "pp")
POLAR_CONFIGS = {
    "1_sector": os.path.join(POLAR_DIR, "polarstream_det_1_sector.py"),
    "4_sector": os.path.join(POLAR_DIR,
                             "polarstream_det_4_sector_bidirectional.py")}
POLAR_SWEEPS = 11            # the configs' nsweeps
POLAR_ROWS = 380_000         # --max_points: every point of an 11-sweep sample
POLAR_TIMED = 3              # timed frames a config after one warm-up
POLAR_TRAIN_STEPS = 1        # timed train steps after one warm-up
POLAR_SMALL_GRID = 128       # the reference's pillar grid, 128 x 128
POLAR_REF_POINTS = 60_000    # the reference sample's first rows
POLAR_TIE = 1e-6             # scores closer than this may swap places


@torch.no_grad()
def polar_census(mod, ex):
    """Sample 0's capacity readings per sector: rows in the sector,
    rows the sector buffer's cap dropped (more than one sector), cells
    occupied on the sector grid, pillars kept of ``max_pillars``, and
    points in dropped pillars; with the share of the sample's in-grid
    points lost to either cap."""
    pts, mask = ex["points"][:1], ex["points_mask"][:1]
    n_sec = mod.n_sectors
    span = mod.angle_span()
    phi = mod.point_azimuth(pts[0])
    sec = torch.clamp(torch.floor((phi - mod.azimuth_origin()) / span), 0,
                      n_sec - 1).long()
    rows = [int((mask[0] & (sec == s)).sum()) for s in range(n_sec)]
    cap = mod.sector_point_cap(pts.shape[1]) if n_sec > 1 else None
    g = mod.sector_grid()
    sr = mod.sector_range()
    size = torch.tensor([mod.voxel_size[0], mod.voxel_size[1],
                         sr[5] - sr[2]], device=pts.device)
    lo = torch.tensor(sr[:3], device=pts.device)
    lim = torch.tensor([g[0], g[1], 1], device=pts.device)
    out, in_grid, lost = [], 0, 0
    for s, (p, v) in enumerate(mod.sector_inputs(pts, mask)):
        co = torch.floor((p[0, :, :3] - lo) / size).long()
        ok = v[0] & ((co >= 0) & (co < lim)).all(1)
        vox = mod.pillarize(p, v)
        dropped = int((ok & (vox["point_voxel"][0] >= mod.max_pillars))
                      .sum())
        cut = max(0, rows[s] - cap) if cap else 0
        out.append(dict(rows=rows[s], cap_dropped=cut,
                        occupied=int(torch.unique(co[ok, 1] * g[0]
                                                  + co[ok, 0]).numel()),
                        pillars=int(vox["mask"][0].sum()),
                        pillar_dropped=dropped))
        in_grid += int(ok.sum()) + cut
        lost += dropped + cut
    return dict(sectors=out, capacity=mod.max_pillars, cap=cap,
                lost_share=lost / max(in_grid, 1))


def polar_nms_readings(det, preds):
    """The decode + stateful NMS of one frame alone on its maps: host ms
    (median of NMS_REPS calls) and the fixpoint sweeps a sector."""
    from partner_tpu_torch.ops import nms

    times, sweeps = [], []
    for _ in range(NMS_REPS):
        nms.sweeps = 0
        ms, _, counts = counted(lambda: det.decode(preds))
        if any(counts.values()):
            raise AssertionError(f"decode + NMS launched {counts}")
        times.append(ms)
        sweeps.append(nms.sweeps / getattr(det.module, "n_sectors", 1))
    return dict(ms=statistics.median(times), all_ms=times,
                sweeps_per_sector=sweeps[0])


@torch.no_grad()
def polar_reference(dev, card, name, ex):
    """A PolarStream config's widths on a POLAR_SMALL_GRID x
    POLAR_SMALL_GRID pillar grid (the sectors cut from it), same weights
    and points (the first POLAR_REF_POINTS rows of ``ex``'s sample): per
    sector the canvas, the neck's output and contexts (each fed the CPU's
    canvas and contexts) and each head map (fed the CPU's neck output) of
    the card against the CPU, both float32, then the kept detections of
    ``predict`` on both."""
    import copy

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(POLAR_CONFIGS[name])
    m = copy.deepcopy(cfg["model"])
    tc = dict(cfg["test_cfg"], score_threshold=0.0)
    vg = m["bbox_head"]["voxel_generator"]
    r = vg["range"]
    vg["voxel_size"] = [(r[3] - r[0]) / POLAR_SMALL_GRID,
                        (r[4] - r[1]) / POLAR_SMALL_GRID,
                        vg["voxel_size"][2]]
    gen = torch.Generator().manual_seed(SEED + 51)
    gpu = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(gpu.module, gen)
    randomize_pfn(gpu.module, gen)
    cpu = build_detector(m, None, tc, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                gpu.module.state_dict().items()})
    exc = {k: v[:1, :POLAR_REF_POINTS].cpu() for k, v in ex.items()}
    exg = {k: v.to(dev) for k, v in exc.items()}
    cm, gm = cpu.module, gpu.module
    ctx = None
    for s, (p, v) in enumerate(cm.sector_inputs(exc["points"],
                                                exc["points_mask"])):
        canvas = cm.encode_sector(p, v)
        rel_rms(f"PolarStream {name} sector {s} canvas on {card}",
                gm.encode_sector(p.to(dev), v.to(dev)), canvas, PP_REF_TOL)
        x, new_ctx = cm.neck(canvas, ctx)
        gx, gctx = gm.neck(canvas.to(dev), None if ctx is None
                           else [c.to(dev) for c in ctx])
        rel_rms(f"PolarStream {name} sector {s} neck", gx, x, PP_REF_TOL)
        for i, (gc, c) in enumerate(zip(gctx, new_ctx)):
            r_i, _ = rel_rms_of(f"context {i}", gc, c)
            if not r_i <= PP_REF_TOL:
                raise AssertionError(f"PolarStream {name} sector {s} "
                                     f"context {i}: {r_i}")
        want = cm.bbox_head(x)["det_preds"][0]
        got = gm.bbox_head(x.to(dev))["det_preds"][0]
        for k in sorted(want):
            rel_rms(f"PolarStream {name} sector {s} head {k}", got[k],
                    want[k], PP_REF_TOL)
        ctx = new_ctx
    want = cpu.predict(exc)
    at_place = same_detections(gpu.predict(exg), want, tie=POLAR_TIE)
    log(f"PolarStream {name} kept detections on {POLAR_SMALL_GRID} x "
        f"{POLAR_SMALL_GRID} pillars, card against CPU: "
        f"{int(want['mask'].sum())} each, {at_place} equal at their place, "
        f"the rest within a score tie of {POLAR_TIE}")
    return at_place


def one_loader_thread():
    """A context in which the evaluator's loader runs one thread, so each
    nuScenes frame draws its sweep order from the dataset's random state
    in frame order, as a direct loop over the dataset does."""
    import contextlib

    from partner_tpu_torch.eval import evaluator

    @contextlib.contextmanager
    def ctx():
        orig = evaluator.build_dataloader
        evaluator.build_dataloader = lambda dataset, batch_size, **kw: orig(
            dataset, batch_size, **dict(kw, workers_per_gpu=1))
        try:
            yield
        finally:
            evaluator.build_dataloader = orig

    return ctx()


def polar_dist_test(det, cfg_path, root, name, card):
    """``dist_test`` of a PolarStream config from a checkpoint of ``det``'s
    weights over the NUSC_FRAMES synthetic frames, as a user runs it (the
    evaluator's 4 loader threads): no kernel launched, the middle-third
    FPS, finite nuScenes metrics and the results json, velocities 0. Then
    once more with the loader at one thread (:func:`one_loader_thread`):
    every frame's kept boxes bit-equal to a direct ``predict`` of the
    frame. With 4 threads a frame's sweeps come in the order the threads
    reach the dataset's random state, the PFN sums a pillar's points in
    their order, and the NMS turns the rounding into other kept boxes
    (ROADMAP.md §3). -> {fps, launches, bit_equal, frames}."""
    import pickle

    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.utils.config import load_config

    ckpt = os.path.join(root, f"ckpt_{name}")
    save_checkpoint(ckpt, 0, det.module.state_dict())
    dev = next(det.module.parameters()).device

    def run(work_dir):
        return counted(lambda: dist_test.main([
            cfg_path, "--checkpoint", os.path.join(ckpt, "latest"),
            "--work_dir", work_dir, "--max_points", str(POLAR_ROWS),
            "--device", dev.type]))

    work_dir = os.path.join(root, f"eval_{name}")
    _, ((metrics, seg, pan), fps), launches = run(work_dir)
    with one_loader_thread():
        _, _, launches_1 = run(work_dir + "_1")
    with open(os.path.join(work_dir + "_1", "prediction.pkl"), "rb") as f:
        preds = pickle.load(f)
    ds = build_dataset(dict(load_config(cfg_path)["data"]["val"]))
    bit_equal = 0
    for b in DataLoader(ds, 1, shuffle=False, num_workers=1,
                        max_points=POLAR_ROWS):
        e = to_device({k: b[k] for k in ("points", "points_mask")}, dev)
        want = kept_boxes(det.predict(e))
        bit_equal += all(np.array_equal(preds[b["metadata"][0]["token"]][k],
                                        want[k]) for k in want)
    if bit_equal != len(preds) or len(preds) != NUSC_FRAMES:
        raise AssertionError(f"PolarStream dist_test ({name}): {bit_equal} "
                             f"of {len(preds)} frames bit-equal to predict")
    none = dict.fromkeys(kernel_wrappers(), 0)
    if launches != none or launches_1 != none:
        raise AssertionError(f"PolarStream dist_test ({name}): launches "
                             f"{launches}, {launches_1}")
    keys = ["mAP", "NDS", "mATE", "mASE", "mAOE", "mAVE"]
    if seg is not None or pan is not None or not all(
            np.isfinite(metrics[k]) for k in keys):
        raise AssertionError(f"PolarStream dist_test ({name}): {metrics}")
    with open(metrics["results_path"]) as f:
        results = json.load(f)["results"]
    with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
        preds = pickle.load(f)
    if sorted(results) != sorted(preds) or not all(
            len(results[t]) == len(preds[t]["scores"]) for t in preds):
        raise AssertionError(f"PolarStream dist_test ({name}): the results "
                             "json")
    if any(d["velocity"] != [0.0, 0.0] for ds_ in results.values()
           for d in ds_):
        raise AssertionError(f"PolarStream dist_test ({name}): a velocity "
                             "in the results (predict keeps 7 columns)")
    log(f"PolarStream dist_test ({name}) on {card}: middle-third FPS "
        f"{fps!r} over {len(preds)} frames of {POLAR_SWEEPS} sweeps in "
        f"{POLAR_ROWS} rows; launches {launches}; " + ", ".join(
            f"{k} {metrics[k]!r}" for k in keys)
        + f"; results json with {sum(map(len, results.values()))} boxes, "
        f"velocities 0; with one loader thread every frame bit-equal to a "
        f"direct predict ({bit_equal} of {len(preds)})")
    return dict(fps=fps, launches=launches, bit_equal=bit_equal,
                frames=len(preds))


def polar_train_cli(cfg_path, root, name, card, dev):
    """Two train-CLI steps of a PolarStream config at batch 2 with a
    checkpoint: finite per-sector losses, no kernel launched.
    -> {launches, wall_s}."""
    from partner_tpu_torch.tools import train

    work_dir = os.path.join(root, f"train_{name}")
    wall_ms, steps, launches = counted(lambda: train.main([
        cfg_path, "--work_dir", work_dir, "--batch_size", "2",
        "--total_steps", "2",
        "--max_steps_per_epoch", "2", "--max_points", str(POLAR_ROWS),
        "--seed", str(SEED), "--device", torch.device(dev).type]))
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ckpts = sorted(d for d in os.listdir(work_dir) if d.startswith("ckpt_"))
    if steps != 2 or ckpts[-1:] != ["ckpt_00000002"] or [
            r["step"] for r in recs] != [0, 1]:
        raise AssertionError(f"PolarStream train CLI ({name}): steps "
                             f"{steps}, checkpoints {ckpts}, records {recs}")
    if launches != dict.fromkeys(kernel_wrappers(), 0):
        raise AssertionError(f"PolarStream train CLI ({name}): launches "
                             f"{launches}")
    for r in recs:
        vals = {k: r[k] for k in r if k in ("loss", "grad_norm")
                or k.startswith("sector")}
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"PolarStream train CLI ({name}): {vals}")
        log(f"PolarStream train CLI ({name}) step {r['step']} on {card}: "
            f"time {r['time']!r} s, data_time {r['data_time']!r} s, {vals}")
    log(f"PolarStream train CLI ({name}): 2 steps at batch 2 and one "
        f"checkpoint in {wall_ms / 1e3!r} s")
    return dict(launches=launches, wall_s=wall_ms / 1e3)


def polarstream_phase(dev, card):
    """The two PolarStream det configs (``configs/nusc/pp/polarstream_det_
    {1_sector,4_sector_bidirectional}.py``: the 512 x 512 polar pillar
    grid cut into 1 or 4 azimuth sectors, ``DynamicPFNet`` 64 -> 128, the
    stream neck ``RPNTECP`` / ``RPNBDCP`` with layer_nums [3, 5, 5],
    ``CenterHeadSinglePos``, the stateful cross-sector NMS) at full width,
    random weights with every norm randomized, on a synthetic 11-sweep
    nuScenes set prepared by the port's ``create_data``, every row of a
    sample kept: each config's frame (median ms of POLAR_TIMED after a
    warm-up, device busy and launches, kept boxes, a repeat bit-equal),
    its decode + stateful NMS alone (ms, fixpoint sweeps a sector), its
    capacity readings (:func:`polar_census`), the card against the CPU on
    a small grid (:func:`polar_reference`), the batch-4 train step (median
    of POLAR_TRAIN_STEPS, peak memory), ``dist_test`` over NUSC_FRAMES
    frames (:func:`polar_dist_test`) and two train-CLI steps. No hand
    kernel lies on this path: every launch count stays 0."""
    import tempfile

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    none = dict.fromkeys(kernel_wrappers(), 0)
    res = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        info = write_nusc_scene(root, np.random.RandomState(SEED + 50),
                                NUSC_FRAMES, POLAR_SWEEPS, NUSC_SWEEP_POINTS)
        log(f"PolarStream set: {NUSC_FRAMES} frames of {POLAR_SWEEPS} "
            f"sweeps of ~{NUSC_SWEEP_POINTS} points written and prepared by "
            f"create_data nuscenes_data_prep in "
            f"{time.perf_counter() - t0:.1f} s")
        for name in POLAR_CONFIGS:
            t_cfg = time.perf_counter()
            cfg_path = write_nusc_config(root, f"polarstream_{name}", info,
                                         POLAR_CONFIGS[name])
            cfg = load_config(cfg_path)
            tc = dict(cfg["test_cfg"])
            gen = torch.Generator().manual_seed(SEED + 52)
            det = build_detector(cfg["model"], cfg["train_cfg"], tc,
                                 device=dev, generator=gen)
            randomize_norms(det.module, gen)
            randomize_pfn(det.module, gen)
            mod = det.module
            t0 = time.perf_counter()
            batch = nusc_batch(cfg_path, "val", 1, rows=POLAR_ROWS)
            host_ms = (time.perf_counter() - t0) * 1e3
            rows = int(batch["points_mask"].sum())
            log(f"PolarStream {name} sample: {rows} points in "
                f"{POLAR_SWEEPS} sweeps; the default --max_points 200000 "
                f"would drop {max(0, rows - 200_000)}; buffer {POLAR_ROWS} "
                f"rows drops none; one sample through the val pipeline in "
                f"{host_ms:.1f} ms on the host; {mod.n_sectors} sectors of "
                f"{mod.sector_grid()[:2]} pillars, capacity "
                f"{mod.max_pillars} a sector, neck "
                f"{type(mod.neck).__name__}")
            if rows >= POLAR_ROWS:
                raise AssertionError(f"PolarStream {name}: the buffer is "
                                     "full")
            ex = to_device({k: batch[k] for k in ("points", "points_mask")},
                           dev)
            median, times, out, tally = timed_predicts(det, ex, POLAR_TIMED,
                                                       none)
            busy, launches = device_busy(lambda: det.predict(ex))
            with torch.no_grad():
                preds = mod(ex)
            sec = preds["sector_preds"]
            if len(sec) != mod.n_sectors or not all(
                    torch.isfinite(v).all() for p in sec
                    for v in p["det_preds"][0].values()):
                raise AssertionError(f"PolarStream {name}: sector maps")
            kept = check_detections(out, tc, n_tasks=mod.n_sectors)
            if not identical(det.predict(ex), out):
                raise AssertionError(f"PolarStream {name}: a repeat differs")
            nms_r = polar_nms_readings(det, preds)
            census = polar_census(mod, ex)
            log(f"PolarStream {name} frame on {card}: "
                f"{tuple(ex['points'].shape)} point rows, median {median!r} "
                f"ms over {POLAR_TIMED} frames (host clock around a "
                f"synchronized predict), all {times!r}; device busy "
                f"{busy!r} ms and {launches!r} launches a frame; kernel "
                f"launches {tally}; hm {tuple(sec[0]['det_preds'][0]['hm'].shape)}"
                f" a sector; {kept} boxes kept; repeat bit-equal; decode + "
                f"stateful NMS alone {nms_r['ms']!r} ms (all "
                f"{nms_r['all_ms']!r}), {nms_r['sweeps_per_sector']!r} "
                f"fixpoint sweeps a sector; capacity {census}")
            r = dict(median_ms=median, device_busy_ms=busy,
                     launches_per_frame=launches, launches=tally, kept=kept,
                     nms=nms_r, census=census, rows=rows)
            del preds, out, sec
            r["reference_at_place"] = polar_reference(dev, card, name, ex)
            del ex
            torch.cuda.empty_cache()

            # ---- the train step at batch 4
            torch.cuda.reset_peak_memory_stats()
            tex = to_device({k: v for k, v in nusc_batch(
                cfg_path, "train", NUSC_TRAIN_BATCH, rows=POLAR_ROWS).items()
                if k in det.loss_keys}, dev)
            step = make_train_step(det, build_one_cycle_optimizer(
                mod, lr_max=cfg["lr_config"]["lr_max"], total_steps=1000))
            tl, t_med, t_times, _, peak = timed_train_steps(
                det, step, tex, None, none, f"PolarStream {name} train step",
                n_steps=POLAR_TRAIN_STEPS)
            log(f"PolarStream {name} train step, batch {NUSC_TRAIN_BATCH}, "
                f"on {card}: median {t_med!r} ms over {POLAR_TRAIN_STEPS} "
                f"steps, all {t_times!r}; peak memory {peak!r} GiB; "
                f"targets {tuple(tex['hm'][0].shape)}; launches {tl}; every "
                "gradient finite, every parameter and BatchNorm statistic "
                "moved")
            r["train"] = dict(median_ms=t_med, peak_gib=peak, launches=tl)
            del step, tex
            torch.cuda.empty_cache()
            r["dist_test"] = polar_dist_test(det, cfg_path, root, name, card)
            del det, mod
            torch.cuda.empty_cache()
            r["train_cli"] = polar_train_cli(cfg_path, root, name, card, dev)
            log(f"PolarStream {name}: {time.perf_counter() - t_cfg:.1f} s")
            res[name] = r
    log(f"PolarStream phase {time.perf_counter() - t_phase:.1f} s in all")
    return res


# ----------------------------------------------------------- segmentation

SEG_CONFIGS = {
    "polarstream_1": os.path.join(POLAR_DIR,
                                  "polarstream_det_n_seg_1_sector.py"),
    "polarstream_4": os.path.join(
        POLAR_DIR, "polarstream_det_n_seg_4_sector_bidirectional.py"),
    "polarstream_4te": os.path.join(
        POLAR_DIR, "polarstream_det_n_seg_4_sector_trailing_edge.py"),
    "voxelnet_10sweep": os.path.join(NUSC_DIR, "voxelnet_seg_10sweep.py"),
    "voxelnet_cylinder": os.path.join(NUSC_DIR, "voxelnet_seg_cylinder.py")}
SEG_FRAMES = 6               # frames on disk, and dist_test's frames
SEG_TIMED = 3                # timed frames a config after one warm-up
SEG_TRAIN_STEPS = 1          # timed train steps after one warm-up
SEG_REF_TOL = 1e-5           # seg logits, card against CPU, float32
SEG_TIE = 1e-4               # top-two logits closer than this: a near-tie
SEG_REF_POINTS = 60_000      # the reference sample's first rows
SEG_SMALL = {"polarstream": (128, 128), "voxelnet": (128, 128, 40)}
SEG_CURRICULUM = 0.5         # the train CLI's curriculum_weights entry


def randomize_masked_norms(module, gen):
    """Draw every ``MaskedBatchNorm``'s scale and bias (the sparse
    backbone's, the pillar encoder's) from ``gen``;
    :func:`randomize_norms` draws their statistics."""
    from partner_tpu_torch.models.layers import MaskedBatchNorm

    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.scale.copy_(0.5 + torch.rand(m.scale.shape, generator=gen))
            m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))


def seg_detector(cfg, dev, gen):
    """A seg config's detector on ``dev`` from ``gen``, every norm drawn,
    and its voxelizers where it takes voxels (predict: the second
    ``max_voxel_num``, train: the first, as the CLIs use them) ->
    (det, predict voxelizer or None, train voxelizer or None)."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    det = build_detector(cfg["model"], cfg["train_cfg"],
                         dict(cfg["test_cfg"]), device=dev, generator=gen)
    with torch.no_grad():
        randomize_norms(det.module, gen)
        randomize_masked_norms(det.module, gen)
    if det.input_kind != "voxels":
        return det, None, None
    vg = cfg["voxel_generator"]
    mv = vg["max_voxel_num"]
    return (det, DeviceVoxelizer(vg, dev, mv[1]),
            DeviceVoxelizer(vg, dev, mv[0]))


def with_voxels(ex, voxelize):
    """The example with the voxel inputs of ``voxelize`` beside its points
    (the seg loss and labels read the points), or as it is."""
    if voxelize is None:
        return ex
    return dict(ex, **voxelize(ex["points"], ex["points_mask"]))


def seg_label_check(name, out, ex, seg_classes=16):
    """``point_seg_labels`` of a frame: (B, P) int, 0 on padding, every
    label in 0..classes, most valid points labelled -> their share."""
    lab = out["point_seg_labels"]
    mask = ex["points_mask"]
    if tuple(lab.shape) != tuple(mask.shape) or lab[~mask].any() or (
            lab.min() < 0 or lab.max() > seg_classes):
        raise AssertionError(f"{name}: point_seg_labels")
    share = float((lab[mask] > 0).float().mean())
    if not share > 0.5:
        raise AssertionError(f"{name}: {share} of the points labelled")
    return share


def near_tie_labels(name, cpu, wsp, ex, wl, gl):
    """Sample 0's point labels ``gl`` (the card's) against ``wl`` (the
    CPU's, from its seg maps ``wsp``, a list a sector): each differing
    point's cell must hold the CPU's two top logits within SEG_TIE (a
    near-tie) -> the differing points."""
    from partner_tpu_torch.models.seg_head import points_to_grid_cells

    differ = torch.nonzero(wl != gl)[:, 0]
    if not len(differ):
        return differ
    top2 = []
    pts, mask = ex["points"], ex["points_mask"]
    if pts.dim() == 4:    # STROBE: the last sweep's points
        pts, mask = pts[:, -1], mask[:, -1]
    for s, w in enumerate(wsp):
        if hasattr(cpu.module, "point_cells"):
            a, rr, ok = cpu.module.point_cells(pts, mask, s)
            cells = w[0][a[0].clamp(0, w.shape[1] - 1),
                         rr[0].clamp(0, w.shape[2] - 1)]
        else:
            gi, ok = points_to_grid_cells(pts, mask, w.shape[1:3],
                                          cpu.module.pc_range,
                                          cpu.voxel_shape)
            cells = w[0][gi[0, :, 1].clamp(0, w.shape[1] - 1),
                         gi[0, :, 2].clamp(0, w.shape[2] - 1)]
        v = torch.topk(cells[differ], 2, dim=-1).values
        top2.append(torch.where(ok[0][differ], v[:, 0] - v[:, 1],
                                torch.full_like(v[:, 0], np.inf)))
    gap = torch.stack(top2).min(0).values
    if not (gap <= SEG_TIE).all():
        raise AssertionError(f"{name}: {len(differ)} point labels differ, "
                             f"gaps {gap.tolist()[:8]}")
    return differ


@torch.no_grad()
def seg_reference(dev, card, name, cfg_path, ex):
    """A seg config's widths on a reduced grid (PolarStream: 128 x 128
    pillars; VoxelNet: 128 x 128 x 40), same weights, the first
    SEG_REF_POINTS rows of ``ex``'s sample, the voxels (VoxelNet) made on
    the CPU and copied: each seg map of the card against the CPU within
    SEG_REF_TOL relative RMS, and ``predict``'s ``point_seg_labels`` equal
    but where the CPU's two top logits at the point's cell lie within
    SEG_TIE (a near-tie) -> (points, near-tie disagreements)."""
    import copy

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(cfg_path)
    m = copy.deepcopy(cfg["model"])
    polar = name.startswith("polarstream")
    grid = SEG_SMALL["polarstream" if polar else "voxelnet"]
    vg = (m["bbox_head"] if polar else m["seg_head"])["voxel_generator"]
    r = vg["range"]
    vg["voxel_size"] = [(r[3 + i] - r[i]) / g for i, g in enumerate(grid)] \
        + list(vg["voxel_size"][len(grid):])
    tc = dict(cfg["test_cfg"], score_threshold=0.0)
    gen = torch.Generator().manual_seed(SEED + 61)
    gpu = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(gpu.module, gen)
    randomize_masked_norms(gpu.module, gen)
    cpu = build_detector(m, None, tc, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                gpu.module.state_dict().items()})
    exc = {k: ex[k][:1, :SEG_REF_POINTS].cpu()
           for k in ("points", "points_mask")}
    if not polar:
        mv = vg["max_voxel_num"]
        exc.update(DeviceVoxelizer(vg, "cpu", mv[1])(exc["points"],
                                                     exc["points_mask"]))
    exg = {k: v.to(dev) for k, v in exc.items()}
    cpu.module.eval()
    want, got = cpu.module(exc), gpu.module(exg)
    wsp, gsp = want["seg_preds"], got["seg_preds"]
    if not polar:
        wsp, gsp = [wsp], [gsp]
    for s, (w, g) in enumerate(zip(wsp, gsp)):
        rel_rms(f"{name} seg map {s} on {grid} on {card}", g, w, SEG_REF_TOL)
    # the CPU's labels from its maps, as its predict computes them
    if polar:
        wl = cpu.point_seg_labels(wsp, exc)[0]
    else:
        from partner_tpu_torch.models.seg_head import (point_labels_from_grid,
                                                       points_to_grid_cells)

        gi, ok = points_to_grid_cells(exc["points"], exc["points_mask"],
                                      wsp[0].shape[1:3], cpu.module.pc_range,
                                      cpu.voxel_shape)
        wl = torch.where(ok, point_labels_from_grid(wsp[0], gi), 0)[0]
    gl = gpu.predict(exg)["point_seg_labels"][0].cpu()
    differ = near_tie_labels(name, cpu, wsp, exc, wl, gl)
    n = int(exc["points_mask"].sum())
    log(f"{name} point_seg_labels on {grid}, card against CPU: "
        f"{n - len(differ)} of {n} equal, {len(differ)} at near-ties "
        f"(top-two logits within {SEG_TIE})")
    return n, len(differ)


def seg_dist_test(det, cfg_path, root, name, card):
    """``dist_test`` of a seg config from a checkpoint of ``det``'s
    weights over the SEG_FRAMES frames of the lidarseg set, as a user runs
    it: no kernel launched, the middle-third FPS, the seg mIoU and the
    panoptic PQ / SQ / RQ finite (and the det metrics for det + seg);
    a seg-only config's ``prediction.pkl`` empty -> {fps, miou, pq,
    launches}."""
    import pickle

    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.checkpoint import save_checkpoint

    ckpt = os.path.join(root, f"ckpt_{name}")
    save_checkpoint(ckpt, 0, det.module.state_dict())
    dev = next(det.module.parameters()).device
    work_dir = os.path.join(root, f"eval_{name}")
    _, ((metrics, miou, pan), fps), launches = counted(
        lambda: dist_test.main([
            cfg_path, "--checkpoint", os.path.join(ckpt, "latest"),
            "--work_dir", work_dir, "--max_points", str(POLAR_ROWS),
            "--device", dev.type]))
    if launches != dict.fromkeys(kernel_wrappers(), 0):
        raise AssertionError(f"{name} dist_test: launches {launches}")
    if miou is None or pan is None or not (
            0 <= miou <= 1 and all(np.isfinite(list(pan.values())))):
        raise AssertionError(f"{name} dist_test: mIoU {miou}, {pan}")
    with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
        preds = pickle.load(f)
    det_cfg = det.module.bbox_head is not None
    if det_cfg != (len(preds) == SEG_FRAMES) or (
            det_cfg and not np.isfinite(metrics["NDS"])):
        raise AssertionError(f"{name} dist_test: {len(preds)} frames of "
                             f"boxes, metrics {metrics}")
    log(f"{name} dist_test on {card}: middle-third FPS {fps!r} over "
        f"{SEG_FRAMES} frames; seg mIoU {miou!r}; panoptic {pan}; "
        + (f"NDS {metrics['NDS']!r}, mAP {metrics['mAP']!r}" if det_cfg
           else "no boxes (prediction.pkl empty)")
        + f"; launches {launches}")
    return dict(fps=fps, miou=miou, pq=pan["PQ"], launches=launches)


def seg_train_cli(cfg_path, root, name, card, dev):
    """Two train-CLI steps of a seg config at batch 2, one an epoch, with ``curriculum_weights = [SEG_CURRICULUM]``: step 0's loss
    takes the seg loss at that weight, step 1's (past the list) at 1.0;
    finite, no kernel launched -> {launches, wall_s}."""
    from partner_tpu_torch.tools import train

    path = os.path.join(root, f"{name}_curriculum.py")
    with open(cfg_path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text + f"curriculum_weights = [{SEG_CURRICULUM}]\n")
    work_dir = os.path.join(root, f"train_{name}")
    wall_ms, steps, launches = counted(lambda: train.main([
        path, "--work_dir", work_dir, "--batch_size", "2", "--total_steps",
        "2", "--max_steps_per_epoch", "1", "--max_points", str(POLAR_ROWS),
        "--seed", str(SEED), "--device", torch.device(dev).type]))
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if steps != 2 or [r["step"] for r in recs] != [0, 1]:
        raise AssertionError(f"{name} train CLI: steps {steps}, {recs}")
    if launches != dict.fromkeys(kernel_wrappers(), 0):
        raise AssertionError(f"{name} train CLI: launches {launches}")
    for r, w in zip(recs, (SEG_CURRICULUM, 1.0)):
        sectors = [r[k] for k in r if k.startswith("sector")]
        det = float(np.mean(sectors)) if sectors else 0.0
        want = det + w * r["seg_loss"]
        if not (np.isfinite(r["grad_norm"]) and abs(r["loss"] - want)
                <= 1e-4 * abs(want)):
            raise AssertionError(f"{name} train CLI step {r['step']}: {r}")
        log(f"{name} train CLI step {r['step']} on {card}: time "
            f"{r['time']!r} s, loss {r['loss']!r} = det {det!r} + {w} x "
            f"seg {r['seg_loss']!r}")
    return dict(launches=launches, wall_s=wall_ms / 1e3)


def seg_phase(dev, card):
    """The five segmentation configs at full width: the det + seg
    PolarStream configs (``configs/nusc/pp/polarstream_det_n_seg_
    {1_sector,4_sector_bidirectional,4_sector_trailing_edge}.py``: 512 x
    512 polar pillars in 1 or 4 sectors, ``SingleConvHead`` over the
    128-channel canvas and the 384-channel neck map) and the seg-only
    VoxelNet configs (``configs/nusc/voxelnet/voxelnet_seg_{10sweep,
    cylinder}.py``: 512 x 512 x 40 / 640 x 640 x 40 voxels through
    ``SpMiddleResNetFHD``, ``RPN`` to 512 channels, ``DeconvConvHead``
    height 40, up_scale 8), random weights with every norm drawn, on a
    synthetic 11-sweep nuScenes set with lidarseg files (the VoxelNet
    configs draw 10 of its sweeps). For each: its frame (median of
    SEG_TIMED after a warm-up, the voxelizer inside the VoxelNet frame;
    device busy and launches, every kernel count 0; the point labels
    checked; a repeat bit-equal), the card against the CPU on a reduced
    grid (:func:`seg_reference`), the train step at batch 4 with the
    points' labels (median of SEG_TRAIN_STEPS, peak memory; the VoxelNet
    step through voxel inputs), ``dist_test`` with the mIoU and PQ
    (:func:`seg_dist_test`) and two train-CLI steps with
    ``curriculum_weights`` (:func:`seg_train_cli`). No hand kernel lies on
    this path."""
    import tempfile

    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    none = dict.fromkeys(kernel_wrappers(), 0)
    res = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        info = write_nusc_scene(root, np.random.RandomState(SEED + 60),
                                SEG_FRAMES, POLAR_SWEEPS, NUSC_SWEEP_POINTS,
                                lidarseg=True)
        log(f"seg set: {SEG_FRAMES} frames of {POLAR_SWEEPS} sweeps of "
            f"~{NUSC_SWEEP_POINTS} points with lidarseg files, written and "
            f"prepared in {time.perf_counter() - t0:.1f} s")
        for name, config in SEG_CONFIGS.items():
            t_cfg = time.perf_counter()
            cfg_path = write_nusc_config(root, f"seg_{name}", info, config)
            cfg = load_config(cfg_path)
            gen = torch.Generator().manual_seed(SEED + 62)
            det, vox_eval, vox_train = seg_detector(cfg, dev, gen)
            mod = det.module
            batch = nusc_batch(cfg_path, "val", 1, rows=POLAR_ROWS)
            rows = int(batch["points_mask"].sum())
            if rows >= POLAR_ROWS:
                raise AssertionError(f"{name}: the buffer is full")
            ex = to_device({k: batch[k] for k in ("points", "points_mask")},
                           dev)

            def run():
                return det.predict(with_voxels(ex, vox_eval))

            median, times, out, tally = timed_predicts(det, ex, SEG_TIMED,
                                                       none, run)
            busy, launches = device_busy(run)
            share = seg_label_check(name, out, ex)
            kept = (check_detections(out, cfg["test_cfg"],
                                     n_tasks=mod.n_sectors)
                    if mod.bbox_head is not None else 0)
            if not identical(run(), out):
                raise AssertionError(f"{name}: a repeat differs")
            with torch.no_grad():
                maps = mod(with_voxels(ex, vox_eval))["seg_preds"]
            shapes = [tuple(m.shape) for m in (
                maps if isinstance(maps, list) else [maps])]
            del maps
            log(f"{name} frame on {card}: {rows} points, median {median!r} "
                f"ms over {SEG_TIMED} frames (host clock around a "
                f"synchronized predict"
                + (", the voxelizer inside" if vox_eval else "")
                + f"), all {times!r}; device busy {busy!r} ms and "
                f"{launches!r} launches a frame; kernel launches {tally}; "
                f"seg maps {shapes}; {share!r} of the points labelled; "
                f"{kept} boxes kept; repeat bit-equal")
            r = dict(median_ms=median, device_busy_ms=busy,
                     launches_per_frame=launches, launches=tally,
                     labelled=share, kept=kept, rows=rows)
            del out
            r["reference"] = seg_reference(dev, card, name, cfg_path, ex)
            del ex
            torch.cuda.empty_cache()

            # ---- the train step at batch 4, with the points' labels
            torch.cuda.reset_peak_memory_stats()
            tb = nusc_batch(cfg_path, "train", NUSC_TRAIN_BATCH,
                            rows=POLAR_ROWS)
            tex = with_voxels(to_device(
                {k: v for k, v in tb.items() if k in det.loss_keys}, dev),
                vox_train)
            step = make_train_step(det, build_one_cycle_optimizer(
                mod, lr_max=cfg["lr_config"]["lr_max"], total_steps=1000))
            tl, t_med, t_times, steps, peak = timed_train_steps(
                det, step, tex, None, none, f"{name} train step",
                n_steps=SEG_TRAIN_STEPS)
            if not all("seg_loss" in st for st in steps):
                raise AssertionError(f"{name} train step: no seg_loss")
            log(f"{name} train step, batch {NUSC_TRAIN_BATCH}, on {card}: "
                f"median {t_med!r} ms over {SEG_TRAIN_STEPS} steps, all "
                f"{t_times!r}; peak memory {peak!r} GiB; labelled points "
                f"{int((tex['points_label'] > 0).sum())}; launches {tl}; "
                "every gradient finite, every parameter and statistic moved")
            r["train"] = dict(median_ms=t_med, peak_gib=peak, launches=tl)
            del step, tex, tb
            torch.cuda.empty_cache()
            r["dist_test"] = seg_dist_test(det, cfg_path, root, name, card)
            del det, mod
            torch.cuda.empty_cache()
            r["train_cli"] = seg_train_cli(cfg_path, root, name, card, dev)
            log(f"{name}: {time.perf_counter() - t_cfg:.1f} s")
            res[name] = r
    log(f"seg phase {time.perf_counter() - t_phase:.1f} s in all")
    return res



# -------------------------------------------------------- STROBE and HAN

STROBE_HAN_CONFIGS = {
    "han_1": os.path.join(POLAR_DIR, "han_1_sector.py"),
    "han_4": os.path.join(POLAR_DIR, "han_4_sectors.py"),
    "strobe_1": os.path.join(POLAR_DIR, "strobe_1_sector.py"),
    "strobe_4": os.path.join(POLAR_DIR, "strobe_4_sector.py")}
SH_SLOTS = 10                # STROBE's sweep slots a frame: the nsweeps
SH_TRAIN_SLOTS = 2           # STROBE's sweep slots in a train step
SH_TIMED = 3                 # timed frames a config after one warm-up
SH_TRAIN_STEPS = 1           # timed train steps after one warm-up
SH_SMALL_GRID = 128          # the reference's pillar grid, 128 x 128
SH_REF_POINTS = 30_000       # the reference: rows a sweep slot (or sample)
SH_EDGE_M = 1e-3             # reference points kept this far off the edges
WARP_SHAPE = (1, 512, 512, 128)   # a 512 x 512 polar map of 128 channels
# the paths each family runs: STROBE has no loader, so no CLI (ROADMAP §3)
SH_PATHS = {"han": ("frame", "train", "dist_test", "train_cli"),
            "strobe": ("frame", "train")}
WARP_RANGE = (0.0, -np.pi, -5.0, 51.2, np.pi, 3.0)
WARP_REF_TOL = 1e-4          # card against CPU, relative RMS (warp_reading)
WARP_EDGE_M = 1e-4           # a one-sided zero's source from the range end


def sweep_split(batch, slots):
    """A collated multi-sweep nuScenes batch (points [x, y, z, intensity,
    time lag, ...] (B, P, C)) -> the (B, S, P_s, C) batch STROBE takes:
    each sample's sweeps by their time lag, oldest first, the last
    ``slots`` of them (S = ``slots``; a sample with fewer leaves its first
    slots empty), each slot padded to the largest sweep's rows rounded up
    to 128; ``points_label`` (B, P_s) of the last slot, the key frame's,
    where the batch has labels; every other key kept. No loader of either
    package builds this batch (ROADMAP.md §3): this harness does."""
    pts, mask = batch["points"], batch["points_mask"]
    labels = batch.get("points_label")
    per = []
    for b in range(len(pts)):
        rows = np.flatnonzero(mask[b])
        lag = pts[b, rows, 4]
        order = np.unique(lag)[::-1][-slots:]     # oldest first
        per.append([rows[lag == t] for t in order])
    n = -(-max(len(r) for sample in per for r in sample) // 128) * 128
    out = np.zeros((len(pts), slots, n, pts.shape[-1]), np.float32)
    m = np.zeros(out.shape[:3], bool)
    lab = np.zeros((len(pts), n), np.int64) if labels is not None else None
    for b, sample in enumerate(per):
        off = slots - len(sample)
        for i, r in enumerate(sample):
            out[b, off + i, :len(r)] = pts[b, r]
            m[b, off + i, :len(r)] = True
        if lab is not None:
            lab[b, :len(sample[-1])] = labels[b, sample[-1]]
    res = dict(batch, points=out, points_mask=m)
    if lab is not None:
        res["points_label"] = lab.astype(labels.dtype)
    return res


def last_sweep(ex):
    """A (B, S, P, C) example's last sweep slot as a (B, P, C) one."""
    if ex["points"].dim() == 3:
        return ex
    return {"points": ex["points"][:, -1],
            "points_mask": ex["points_mask"][:, -1]}


@torch.no_grad()
def warp_reading(dev, card):
    """``ego_motion_warp_polar`` at WARP_SHAPE (a 512 x 512 polar map of
    128 float32 channels over WARP_RANGE, a transform of 1.5 m, -0.8 m and
    0.05 rad, so samples cross the seam and leave the radial range) on the
    card against the CPU, its device ms beside its bound (the map read
    once, the output written once) -> readings. A sample's azimuth
    coordinate near 512 cells resolves 2^-14 of a cell in float32, and the
    card's cos / sin / atan2 / hypot round apart from the CPU's, so a unit
    normal map (steps of ~1.4 a cell) is held within WARP_REF_TOL relative
    RMS; a cell zeroed on one side only must have its source within
    WARP_EDGE_M of the radial range's ends."""
    from partner_tpu_torch.ops.warp import (ego_motion_warp_polar,
                                            make_bev_transform,
                                            polar_cell_centers)

    gen = torch.Generator().manual_seed(SEED + 71)
    f = torch.randn(WARP_SHAPE, generator=gen)
    tf = make_bev_transform(torch.tensor([1.5]), torch.tensor([-0.8]),
                            torch.tensor([0.05]))
    want = ego_motion_warp_polar(f, tf, WARP_RANGE)
    fg, tg = f.to(dev), tf.to(dev)
    got = ego_motion_warp_polar(fg, tg, WARP_RANGE)
    r, max_err = rel_rms_of("warp", got, want)
    wz, gz = (want == 0).all(-1)[0], (got.cpu() == 0).all(-1)[0]
    rho, phi = polar_cell_centers(WARP_SHAPE[1], WARP_SHAPE[2], WARP_RANGE)
    m = tf[0]
    x, y = rho * torch.cos(phi), rho * torch.sin(phi)
    src = torch.hypot(m[0, 0] * x + m[0, 1] * y + m[0, 2],
                      m[1, 0] * x + m[1, 1] * y + m[1, 2])
    edge = torch.minimum((src - WARP_RANGE[0]).abs(),
                         (src - WARP_RANGE[3]).abs())
    one_side = wz != gz
    if not r <= WARP_REF_TOL or not bool((edge[one_side]
                                          <= WARP_EDGE_M).all()):
        raise AssertionError(f"warp on {card}: relative RMS {r}, "
                             f"{int(one_side.sum())} cells zeroed on one "
                             "side only")
    ms = device_ms(lambda: ego_motion_warp_polar(fg, tg, WARP_RANGE))
    b_ms, by = bound({"bytes": 2 * f.numel() * 4, "flops": {"f32": 0}})
    log(f"ego_motion_warp_polar {WARP_SHAPE} on {card}: against the CPU "
        f"relative RMS {r!r} (bound {WARP_REF_TOL}), max abs err "
        f"{max_err!r}, {int(wz.sum())} cells zeroed on the CPU (sources "
        f"outside the radial range), {int(one_side.sum())} of them or "
        f"others on one side only (each within {WARP_EDGE_M} m of an end); "
        f"device {ms!r} ms, bound {b_ms!r} ms ({by})")
    return dict(rel_rms=r, max_abs_err=max_err, device_ms=ms, bound_ms=b_ms,
                one_side=int(one_side.sum()))


def edge_clear(ex, cell):
    """The example with every valid point's x and y moved SH_EDGE_M off
    the multiples of ``cell`` (the pillar edges, the axes among them) and
    its rho and phi columns recomputed: the card's and the CPU's float32
    ``cos`` / ``sin`` differ by an ulp, so a cuboid sector's turned point
    within an ulp of an edge can change pillar or sector between them."""
    pts = ex["points"].clone()
    xy = pts[..., :2].double()
    k = torch.round(xy / cell)
    near = (xy - k * cell).abs() < SH_EDGE_M
    xy = torch.where(near, k * cell + torch.where(xy >= k * cell, 1.0, -1.0)
                     * 2 * SH_EDGE_M, xy)
    pts[..., :2] = xy.float()
    pts[..., -2] = torch.hypot(pts[..., 0], pts[..., 1])
    pts[..., -1] = torch.atan2(pts[..., 1], pts[..., 0])
    return dict(ex, points=pts)


@torch.no_grad()
def moved_points(cpu_mod, gpu_mod, ex):
    """Sector modules: the valid points whose sector pillar the card's
    turned coordinates put elsewhere than the CPU's, and the most their x
    and y differ (m), over every sector of ``ex``'s last sweep."""
    e = last_sweep(ex)
    g = cpu_mod.sector_grid()
    sr = cpu_mod.sector_range()
    size = torch.tensor(cpu_mod.voxel_size[:2])
    lo = torch.tensor(sr[:2])
    moved, diff = 0, 0.0
    cpu_in = cpu_mod.sector_inputs(e["points"], e["points_mask"])
    dev = next(gpu_mod.parameters()).device
    gpu_in = gpu_mod.sector_inputs(e["points"].to(dev),
                                   e["points_mask"].to(dev))
    for (cp, cv), (gp, gv) in zip(cpu_in, gpu_in):
        gp, gv = gp.cpu(), gv.cpu()
        ok = cv | gv
        cc = torch.floor((cp[..., :2] - lo) / size)
        gc = torch.floor((gp[..., :2] - lo) / size)
        moved += int((ok & ((cc != gc).any(-1) | (cv != gv))).sum())
        diff = max(diff, float((cp[..., :2] - gp[..., :2])[ok].abs().max()))
    return moved, diff, g


@torch.no_grad()
def sh_reference(dev, card, name, ex):
    """A HAN or STROBE config's widths on a SH_SMALL_GRID x SH_SMALL_GRID
    pillar grid (the sectors cut from it), same weights, on the first
    SH_REF_POINTS rows of each of ``ex``'s last two sweep slots (STROBE)
    or of its sample (HAN): for the sector configs, the points whose
    pillar the card's turned coordinates move against the CPU's (counted,
    and stated); then on the sample with every x and y SH_EDGE_M off the
    grid's pillar edges (:func:`edge_clear`), every head and seg map of the
    card against the CPU within PP_REF_TOL relative RMS, both float32, and
    the kept detections and point labels of ``predict``."""
    import copy

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(STROBE_HAN_CONFIGS[name])
    m = copy.deepcopy(cfg["model"])
    tc = dict(cfg["test_cfg"], score_threshold=0.0)
    vg = m["bbox_head"]["voxel_generator"]
    r = vg["range"]
    vg["voxel_size"] = [(r[3] - r[0]) / SH_SMALL_GRID,
                        (r[4] - r[1]) / SH_SMALL_GRID, vg["voxel_size"][2]]
    gen = torch.Generator().manual_seed(SEED + 73)
    gpu = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(gpu.module, gen)
    randomize_pfn(gpu.module, gen)
    cpu = build_detector(m, None, tc, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                gpu.module.state_dict().items()})
    if ex["points"].dim() == 4:
        exc = {k: v[:1, -2:, :SH_REF_POINTS].cpu() for k, v in ex.items()
               if k in ("points", "points_mask")}
    else:
        exc = {k: v[:1, :SH_REF_POINTS].cpu() for k, v in ex.items()
               if k in ("points", "points_mask")}
    moved = None
    if hasattr(cpu.module, "n_sectors") and cpu.module.n_sectors > 1:
        moved, diff, g = moved_points(cpu.module, gpu.module, exc)
        log(f"{name} on {SH_SMALL_GRID} x {SH_SMALL_GRID} pillars (sector "
            f"grid {g[:2]}): {moved} of "
            f"{int(last_sweep(exc)['points_mask'].sum())} points of the last "
            f"sweep change pillar or sector between the card's turned "
            f"coordinates and the CPU's (x, y apart by at most {diff!r} m)")
    exc = edge_clear(exc, vg["voxel_size"][0])
    exg = {k: v.to(dev) for k, v in exc.items()}
    cpu.module.eval()
    want, got = cpu.module(exc), gpu.module(exg)

    def maps(out):
        secs = out.get("sector_preds") or [out]
        flat = [(f"sector {s} {k}", v) for s, p in enumerate(secs)
                for k, v in sorted(p["det_preds"][0].items())]
        segs = out.get("seg_preds")
        segs = segs if isinstance(segs, list) else [segs]
        return flat + [(f"seg {s}", v) for s, v in enumerate(segs)]

    for (k, w), (_, gv) in zip(maps(want), maps(got)):
        rel_rms(f"{name} {k} on {card}", gv, w, PP_REF_TOL)
    wp, gp = cpu.predict(exc), gpu.predict(exg)
    at_place = same_detections(gp, wp, tie=POLAR_TIE)
    segs = want["seg_preds"]
    differ = near_tie_labels(name, cpu, segs if isinstance(segs, list)
                             else [segs], exc, wp["point_seg_labels"][0],
                             gp["point_seg_labels"][0].cpu())
    n = int(last_sweep(exc)["points_mask"].sum())
    log(f"{name} kept detections on {SH_SMALL_GRID} x {SH_SMALL_GRID} "
        f"pillars, card against CPU: {int(wp['mask'].sum())} each, "
        f"{at_place} equal at their place, the rest within a score tie of "
        f"{POLAR_TIE}; point labels {n - len(differ)} of {n} equal, "
        f"{len(differ)} at near-ties (top-two logits within {SEG_TIE})")
    return dict(at_place=at_place, moved=moved, label_ties=len(differ))


def sh_train_cli(cfg_path, root, name, card, dev):
    """One train-CLI step of a HAN config at batch 2: finite losses (every
    sector's, the 4-sector targets assigned at the model's 4 sectors),
    no kernel launched -> {launches, wall_s}."""
    from partner_tpu_torch.tools import train

    work_dir = os.path.join(root, f"train_{name}")
    wall_ms, steps, launches = counted(lambda: train.main([
        cfg_path, "--work_dir", work_dir, "--batch_size", "2",
        "--total_steps", "1", "--max_steps_per_epoch", "1",
        "--max_points", str(POLAR_ROWS), "--seed", str(SEED),
        "--device", torch.device(dev).type]))
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    n_sec = 4 if name.endswith("4") else 1
    want_keys = ([f"sector{s}_loss" for s in range(n_sec)] if n_sec > 1
                 else ["hm_loss"])
    if steps != 1 or [r["step"] for r in recs] != [0] or not all(
            k in recs[0] for k in want_keys + ["seg_loss"]):
        raise AssertionError(f"{name} train CLI: steps {steps}, {recs}")
    if launches != dict.fromkeys(kernel_wrappers(), 0):
        raise AssertionError(f"{name} train CLI: launches {launches}")
    vals = {k: recs[0][k] for k in recs[0]
            if k in ["loss", "grad_norm", "seg_loss"] + want_keys}
    flat = [x for v in vals.values()
            for x in (v if isinstance(v, list) else [v])]
    if not all(np.isfinite(flat)):
        raise AssertionError(f"{name} train CLI: {vals}")
    log(f"{name} train CLI step 0 on {card}: time {recs[0]['time']!r} s, "
        f"data_time {recs[0]['data_time']!r} s, {vals}")
    return dict(launches=launches, wall_s=wall_ms / 1e3)


def strobe_han_phase(dev, card):
    """The four HAN and STROBE configs (``configs/nusc/pp/{han_1_sector,
    han_4_sectors,strobe_1_sector,strobe_4_sector}.py``: 512 x 512 cuboid
    pillars, ``DynamicPFNet`` 64 -> 128, HAN 1-sector ``RPN`` and
    PointPillars' seg head at 32,768 pillars; HAN 4-sector 4 wedges of
    256 x 256 at 7,504 pillars with ``RPNWaymo``'s ConvLSTM and the sector
    LSTM; STROBE ``RPNUber`` over SH_SLOTS sweep slots at 30,000 pillars,
    or 4 wedges at 7,504; ``CenterHeadSingle`` and ``SingleConvHead``) at
    full width, random weights with every norm drawn, on a synthetic
    11-sweep nuScenes set with lidarseg files (10 sweeps a sample, as the
    configs draw them; STROBE's (B, S, P, C) batch split from it by
    :func:`sweep_split`). First ``ego_motion_warp_polar`` at WARP_SHAPE
    (:func:`warp_reading`). For each config: its frame (median of SH_TIMED
    after a warm-up, device busy and launches, every kernel count 0; the
    point labels; a repeat bit-equal), decode + NMS alone, pillars
    occupied against each cap, the card against the CPU on a reduced grid
    (:func:`sh_reference`), the train step at batch 4 (STROBE at
    SH_TRAIN_SLOTS sweep slots; median of SH_TRAIN_STEPS, peak memory);
    for HAN ``dist_test`` (:func:`seg_dist_test`) and one train-CLI step.
    No hand kernel lies on this path."""
    import tempfile

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    none = dict.fromkeys(kernel_wrappers(), 0)
    res = {"warp": warp_reading(dev, card)}
    batches = {}
    with tempfile.TemporaryDirectory() as root:
        info = write_nusc_scene(root, np.random.RandomState(SEED + 70),
                                SEG_FRAMES, POLAR_SWEEPS, NUSC_SWEEP_POINTS,
                                lidarseg=True)
        for name, config in STROBE_HAN_CONFIGS.items():
            t_cfg = time.perf_counter()
            cfg_path = write_nusc_config(root, f"sh_{name}", info, config)
            cfg = load_config(cfg_path)
            tc = dict(cfg["test_cfg"])
            gen = torch.Generator().manual_seed(SEED + 72)
            det = build_detector(cfg["model"], cfg["train_cfg"], tc,
                                 device=dev, generator=gen)
            randomize_norms(det.module, gen)
            randomize_pfn(det.module, gen)
            mod = det.module
            n_sec = getattr(mod, "n_sectors", 1)
            strobe = det.input_kind == "sweeps"
            # STROBE's pipelines are HAN's (its files exec han_1_sector.py):
            # a batch is built once for each sector count
            if ("val", n_sec) not in batches:
                batches["val", n_sec] = nusc_batch(cfg_path, "val", 1,
                                                   rows=POLAR_ROWS)
            batch = batches["val", n_sec]
            rows = int(batch["points_mask"].sum())
            if rows >= POLAR_ROWS:
                raise AssertionError(f"{name}: the buffer is full")
            if strobe:
                batch = sweep_split(batch, SH_SLOTS)
            ex = to_device({k: batch[k] for k in ("points", "points_mask")},
                           dev)
            median, times, out, tally = timed_predicts(det, ex, SH_TIMED,
                                                       none)
            busy, launches = device_busy(lambda: det.predict(ex))
            share = seg_label_check(name, out, last_sweep(ex))
            # a CenterPointDetector keeps the velocity, PolarStream drops it
            kept = check_detections(out, tc, n_tasks=n_sec,
                                    box_dim=9 if n_sec == 1 else 7)
            if not identical(det.predict(ex), out):
                raise AssertionError(f"{name}: a repeat differs")
            with torch.no_grad():
                preds = mod(ex)
            nms_r = polar_nms_readings(det, preds)
            last = last_sweep(ex)
            if n_sec > 1:
                census = polar_census(mod, last)
            else:
                occ, kept_p, dropped = pillar_census(mod, last)
                census = dict(occupied=occ, pillars=kept_p,
                              capacity=mod.max_pillars,
                              dropped_points=dropped)
            log(f"{name} frame on {card}: {rows} points"
                + (f" in {tuple(ex['points'].shape)} sweep slots" if strobe
                   else "") + f", median {median!r} ms over {SH_TIMED} "
                f"frames (host clock around a synchronized predict), all "
                f"{times!r}; device busy {busy!r} ms and {launches!r} "
                f"launches a frame; kernel launches {tally}; {kept} boxes "
                f"kept; {share!r} of the last sweep's points labelled; "
                f"repeat bit-equal; decode + NMS alone {nms_r['ms']!r} ms "
                f"(all {nms_r['all_ms']!r}), {nms_r['sweeps_per_sector']!r} "
                f"fixpoint sweeps a sector; pillars {census}")
            r = dict(median_ms=median, device_busy_ms=busy,
                     launches_per_frame=launches, launches=tally, kept=kept,
                     labelled=share, nms=nms_r, census=census, rows=rows)
            del preds, out
            r["reference"] = sh_reference(dev, card, name, ex)
            del ex
            torch.cuda.empty_cache()

            # ---- the train step at batch 4 (STROBE: SH_TRAIN_SLOTS sweeps)
            torch.cuda.reset_peak_memory_stats()
            if ("train", n_sec) not in batches:
                batches["train", n_sec] = nusc_batch(
                    cfg_path, "train", NUSC_TRAIN_BATCH, rows=POLAR_ROWS,
                    n_sectors=n_sec)
            tb = batches["train", n_sec]
            if strobe:
                tb = sweep_split(tb, SH_TRAIN_SLOTS)
            tex = to_device({k: v for k, v in tb.items()
                             if k in det.loss_keys}, dev)
            step = make_train_step(det, build_one_cycle_optimizer(
                mod, lr_max=cfg["lr_config"]["lr_max"], total_steps=1000))
            tl, t_med, t_times, steps, peak = timed_train_steps(
                det, step, tex, None, none, f"{name} train step",
                n_steps=SH_TRAIN_STEPS)
            if not all("seg_loss" in st for st in steps):
                raise AssertionError(f"{name} train step: no seg_loss")
            log(f"{name} train step, batch {NUSC_TRAIN_BATCH}, on {card}: "
                f"median {t_med!r} ms over {SH_TRAIN_STEPS} steps, all "
                f"{t_times!r}; points {tuple(tex['points'].shape)}; peak "
                f"memory {peak!r} GiB; targets {tuple(tex['hm'][0].shape)}; "
                f"launches {tl}; every gradient finite, every parameter and "
                "statistic moved")
            r["train"] = dict(median_ms=t_med, peak_gib=peak, launches=tl,
                              points=tuple(tex["points"].shape))
            del step, tex
            torch.cuda.empty_cache()
            if not strobe:
                r["dist_test"] = seg_dist_test(det, cfg_path, root, name,
                                               card)
                del det, mod
                torch.cuda.empty_cache()
                r["train_cli"] = sh_train_cli(cfg_path, root, name, card,
                                              dev)
            log(f"{name}: {time.perf_counter() - t_cfg:.1f} s")
            res[name] = r
    log(f"STROBE and HAN phase {time.perf_counter() - t_phase:.1f} s in all")
    return res


# ------------------------------------------------------ data parallelism

DIST_TIMED = 3       # timed steps each way after one warm-up (dist phase)
DIST_FRAMES = 8      # dist_test frames under torchrun
DIST_TRAIN_FRAMES = 4  # the torchrun train CLI's set: one batch of 4
DIST_LR = dict(type="cosine", lr=1e-3, target_lr=1e-5, warmup="linear",
               warmup_iters=1, warmup_ratio=0.1, by_epoch=False)
DIST_OPTIMIZERS = (dict(type="sgd", momentum=0.9),
                   dict(type="amsgrad", wd=0.01),
                   dict(type="adamw", betas=(0.9, 0.99), wd=0.01))
# the lr family on the card against CPU copies: one update apart by float32
# rounding (the global norm summed in another order moves the clip scale
# by an ulp), so |card - cpu| <= DIST_OPT_TOL * (|cpu| + the update's size)
DIST_OPT_TOL = 1e-5
DIST_GRAD_CLIP = 35.0     # build_one_cycle_optimizer's global-norm clip
DIST_ADAM_CLEAR = 1e-7    # a clipped gradient clear of Adam's eps (1e-8)
DIST_LOOSE_SHARE = 0.01   # elements where Adam's first step is not determined
_DIST_RUNNER = r"""
import json, sys, time
import torch
import torch.distributed as tdist
from partner_tpu_torch.ops import scatter_max, stem, swin_attn, swin_block
from partner_tpu_torch.parallel import dist
from partner_tpu_torch.tools import dist_test, train
wrappers = {"stem": stem.stem2_channel_major,
            "scatter_max": scatter_max.scatter_max_fold2d,
            "swin_attn": swin_attn.swin_vote_attention,
            "swin_block": swin_block.swin_vote_block}
assert dist.initialize("cuda")
info = {"backend": tdist.get_backend(), "world": tdist.get_world_size(),
        "device": torch.cuda.current_device()}
for w in wrappers.values():
    w.launches = 0
t0 = time.perf_counter()
if sys.argv[1] == "train":
    out = train.main(sys.argv[2:])
else:
    out = dist_test.main(sys.argv[2:])[1]
torch.cuda.synchronize()
info.update(out=out, wall_s=time.perf_counter() - t0,
            launches={k: w.launches for k, w in wrappers.items()},
            jax=[m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "flax", "optax", "partner_tpu")])
dist.finalize()
print("DIST_RESULT " + json.dumps(info), flush=True)
"""


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(root, tool, args, timeout=600):
    """``tool`` (train or dist_test) through ``python -m
    torch.distributed.run --standalone --nproc_per_node 1`` on the card ->
    the runner's record: backend, world size, the tool's return, wall s,
    the kernels' launches in that process."""
    runner = os.path.join(root, "dist_runner.py")
    with open(runner, "w") as f:
        f.write(_DIST_RUNNER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", runner, tool] + list(args), cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"torchrun {tool} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith("DIST_RESULT ")]
    if len(lines) != 1:
        raise AssertionError(f"torchrun {tool}: no result\n"
                             f"{proc.stdout[-3000:]}")
    rec = json.loads(lines[0][len("DIST_RESULT "):])
    if rec["jax"] or rec["backend"] != "nccl" or rec["world"] != 1:
        raise AssertionError(f"torchrun {tool}: {rec}")
    return rec


def ddp_steps(det, init, ex, lr_max):
    """DIST_TIMED + 1 steps of the flagship from the weights ``init``, the
    same batch and dropout draws each step, data-parallel where a process
    group exists ->
    (step 0's metrics, gradients and state after it on the CPU, the
    median ms of the timed steps, all their ms, collectives a step,
    launches summed)."""
    from partner_tpu_torch.parallel import dist
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    det.module.load_state_dict(init)
    step = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max=lr_max, total_steps=1000))
    data_parallel = torch.distributed.is_initialized()
    want = {"stem": 0, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    first, times, coll = None, [], []
    launches = dict.fromkeys(want, 0)
    for i in range(DIST_TIMED + 1):
        n0 = dist.counts["collectives"]
        ms, met, counts = counted(lambda: step(
            ex, torch.Generator().manual_seed(SEED + 61)))
        coll.append(dist.counts["collectives"] - n0)
        if counts != want:
            raise AssertionError(f"dist step {i} (data_parallel "
                                 f"{data_parallel}): launches {counts}")
        for k in launches:
            launches[k] += counts[k]
        vals = {k: float(v) for k, v in met.items()}
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"dist step {i}: {vals}")
        if i == 0:
            first = (vals, {k: p.grad.float().cpu() for k, p in
                            det.module.named_parameters()},
                     {k: v.float().cpu() for k, v in
                      det.module.state_dict().items()})
        else:
            times.append(ms)
        log(f"dist step {i}, data_parallel {data_parallel}: {ms!r} ms, "
            f"{coll[-1]} collectives, {vals}")
    return first, statistics.median(times), times, coll, launches


def family_on_card(det, dev):
    """The lr family's optimizers (DIST_OPTIMIZERS under DIST_LR) on the
    flagship's parameters with their last step's gradients, three updates
    on the card against the same on CPU copies; the lr each sgd update
    applied, read back from the update (no decay: ``-dp / trace``),
    against ``build_lr_schedule``. -> {type: (largest error against the
    bound's scale, lrs read back)}."""
    from partner_tpu_torch.train.optim import (build_lr_schedule,
                                               build_optimizer)

    class Params(torch.nn.Module):
        def __init__(self, tensors):
            super().__init__()
            self.names = list(tensors)
            self.ps = torch.nn.ParameterList(
                [torch.nn.Parameter(t.clone()) for t in tensors.values()])

        def named_parameters(self, *a, **k):
            return zip(self.names, self.ps)

    params = {k: p.detach().float() for k, p in
              det.module.named_parameters()}
    grads = {k: p.grad.detach().float() for k, p in
             det.module.named_parameters()}
    sched = build_lr_schedule(DIST_LR, 10)
    out = {}
    for cfg in DIST_OPTIMIZERS:
        sides = {}
        for side in ("card", "cpu"):
            mod = Params({k: v if side == "card" else v.cpu()
                          for k, v in params.items()})
            opt = build_optimizer(cfg, build_lr_schedule(DIST_LR, 10), mod,
                                  no_wd_patterns=("bbox_head",))
            lrs = []
            for i in range(3):
                for (k, p) in mod.named_parameters():
                    g = grads[k] * (1.0 + 0.5 * i)
                    p.grad = g if side == "card" else g.cpu()
                prev = {k: p.detach().clone() for k, p in
                        mod.named_parameters()}
                opt.step()
                if cfg["type"] == "sgd":   # the largest tensor's largest
                    j = max(range(len(opt.params)),
                            key=lambda i: opt.params[i].numel())
                    t = opt.trace[j].flatten()
                    top = torch.argmax(t.abs())
                    dp = (opt.params[j].detach().flatten()
                          - prev[mod.names[j]].flatten())[top]
                    lrs.append(float(-dp / t[top]))
            sides[side] = ({k: p.detach().float().cpu() for k, p in
                            mod.named_parameters()}, lrs)
        worst = max(float(((sides["card"][0][k] - sides["cpu"][0][k]).abs()
                           / ((sides["cpu"][0][k]).abs()
                              + (sides["cpu"][0][k] - params[k].cpu()).abs()
                              + 1e-12)).max())
                    for k in params)
        want = [float(sched(i)) for i in range(3)]
        out[cfg["type"]] = (worst, sides["card"][1], want)
        log(f"dist lr family {cfg}: card against CPU largest relative error "
            f"{worst!r} (bound {DIST_OPT_TOL})" + (
                f"; sgd lrs read back {sides['card'][1]!r}, schedule {want!r}"
                if cfg["type"] == "sgd" else ""))
        if not worst <= DIST_OPT_TOL:
            raise AssertionError(f"dist: {cfg['type']} on the card {worst}")
        if cfg["type"] == "sgd" and not np.allclose(sides["card"][1], want,
                                                    rtol=1e-3):
            raise AssertionError(f"dist: sgd lrs {sides['card'][1]} against "
                                 f"the schedule {want}")
    return out


def dist_phase(dev, card):
    """Data parallelism of the port on the one card: (a) an NCCL group of
    one made in process by ``parallel.dist.initialize`` (torchrun's
    variables set by hand, a free localhost port), the flagship's float32
    train step at full width and the train phase's batch (4 x 150,000
    points in 180,000 rows) data-parallel (``DistributedDataParallel``,
    the global BatchNorm statistics and loss normalizers through NCCL)
    against the plain step from the same weights, batch and dropout draws:
    each loss term and the gradients by top-level module (bounds of the
    float32 train reference), the parameters after the step (2e-6 where
    Adam's first step is determined, at most 1% of the elements elsewhere),
    the statistics (bit-equality recorded), DIST_TIMED timed steps each way, collectives a
    step and the scatter-max once a step; (b) the lr family on the card
    against CPU copies (:func:`family_on_card`); (c) with the group left,
    both CLIs through ``python -m torch.distributed.run --standalone
    --nproc_per_node 1``: ``dist_test`` of the flagship (bf16, seeded
    weights) over DIST_FRAMES synthetic sweeps, its ``prediction.pkl``
    bit-equal frame by frame to the same CLI run without a group, the
    stem, attention and scatter-max kernels launched; and two train-CLI
    steps at batch 4 with GT-AUG, ``adamw`` under a cosine schedule after
    a linear warmup: finite losses, the logged lr the schedule's."""
    import pickle
    import tempfile

    import torch.distributed as tdist

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.parallel import dist
    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.train.optim import build_lr_schedule

    t_phase = time.perf_counter()
    m, tc, batch, lr_max = train_cfgs(compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 61)
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    init = {k: v.clone() for k, v in det.module.state_dict().items()}
    ex = to_device(train_example(
        np.random.RandomState(SEED + 61), m["bbox_head"]["voxel_generator"][
            "range"], det.module.grid_size, batch, TRAIN_POINTS, TRAIN_ROWS,
        MAX_BOXES), dev)
    plain = ddp_steps(det, init, ex, lr_max)   # no group yet: the plain step
    saved = {k: os.environ.get(k) for k in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    try:
        if not dist.initialize("cuda"):
            raise AssertionError("dist: no group made")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"dist: process group backend {tdist.get_backend()}, world "
        f"{tdist.get_world_size()}, device {torch.cuda.current_device()}")
    ddp = ddp_steps(det, init, ex, lr_max)
    (pv, pg, ps), (dv, dg, ds) = plain[0], ddp[0]
    bad = {}
    if pv["num_matched"] != dv["num_matched"]:
        bad["num_matched"] = (dv["num_matched"], pv["num_matched"])
    loss_err = {k: abs(dv[k] - pv[k]) / abs(pv[k]) for k in pv
                if k.startswith("loss")}
    for k, e in loss_err.items():
        if not e <= TRAIN_F32_LOSS_TOL:
            bad[k] = e
    gerr = grad_errors(dg, pg)
    for k, (e, _) in gerr.items():
        if not e <= TRAIN_F32_GRAD_TOL[k]:
            bad[f"grad {k}"] = e
    params = dict(det.module.named_parameters())
    lr0 = lr_max / 10.0
    # Adam's first step is about +-lr0 on every element whatever the
    # gradient, so two first steps are always within 2 lr0. Where the
    # clipped gradients agree within 1% and stand clear of eps (1e-8) by
    # DIST_ADAM_CLEAR the step is determined (the two steps then differ by
    # at most ~1e-3 lr0), and there the two must agree to 2e-6; at most
    # DIST_LOOSE_SHARE of the elements may lie elsewhere
    # (tests/test_torch_dist.py's "agree" rule, PARTNER's share).
    clip = min(1.0, DIST_GRAD_CLIP / pv["grad_norm"])
    moved = firm_err = 0.0
    n_loose = n_all = 0
    for k in params:
        d = (ds[k] - ps[k]).abs()
        g, gp = dg[k] * clip, pg[k] * clip
        firm = ((gp.abs() > DIST_ADAM_CLEAR)
                & ((g - gp).abs() <= 1e-2 * gp.abs()))
        moved = max(moved, float(d.max()))
        if firm.any():
            firm_err = max(firm_err, float(
                (d[firm] - 1e-6 * ps[k][firm].abs()).max()))
        n_loose += int((~firm).sum())
        n_all += firm.numel()
    loose_share = n_loose / n_all
    if not moved <= 2 * lr0 * 1.01:
        bad["parameters"] = moved
    if not firm_err <= 2e-6:
        bad["parameters where the step is determined"] = firm_err
    if not loose_share <= DIST_LOOSE_SHARE:
        bad["share of undetermined elements"] = loose_share
    stat_err = max([rel_rms_of(k, ds[k], ps[k])[0] for k in ps
                    if k not in params and not torch.equal(ds[k], ps[k])],
                   default=0.0)
    if not stat_err <= TRAIN_F32_LOSS_TOL:
        bad["statistics"] = stat_err
    bit_equal = all(torch.equal(ds[k], ps[k]) for k in ps)
    log(f"dist (a): DDP step against the plain step from the same weights, "
        f"batch and draws: num_matched {dv['num_matched']!r} / "
        f"{pv['num_matched']!r}, loss terms' relative errors {loss_err} "
        f"(bound {TRAIN_F32_LOSS_TOL}), grad relative RMS and norm ratio by "
        f"module {gerr} (bounds {TRAIN_F32_GRAD_TOL}), parameters after: "
        f"where Adam's step is determined within {firm_err!r} beyond 1e-6 "
        f"relative (bound 2e-6), elsewhere within {moved!r} (bound 2 lr = "
        f"{2 * lr0!r}) on {loose_share!r} of the elements (bound "
        f"{DIST_LOOSE_SHARE}), statistics relative "
        f"RMS {stat_err!r} (bound {TRAIN_F32_LOSS_TOL}); bit-equal: "
        f"{bit_equal}")
    if bad:
        raise AssertionError(f"dist (a): DDP step beyond its bounds: {bad}")
    if len(set(ddp[3])) != 1 or not ddp[3][0] > 0 or any(plain[3]):
        raise AssertionError(f"dist (a): collectives DDP {ddp[3]}, plain "
                             f"{plain[3]}")
    log(f"dist (a): flagship float32 step at batch {batch} on {card}: plain "
        f"median {plain[1]!r} ms {plain[2]!r}, DDP (NCCL, world 1) median "
        f"{ddp[1]!r} ms {ddp[2]!r}; {ddp[3][0]} collectives a DDP step; "
        f"launches over {DIST_TIMED + 1} steps each: plain {plain[4]}, DDP "
        f"{ddp[4]}")
    family = family_on_card(det, dev)
    del det
    dist.finalize()
    torch.cuda.empty_cache()
    if tdist.is_initialized():
        raise AssertionError("dist: the group outlived the in-process part")

    with tempfile.TemporaryDirectory() as root:
        fm, ftc = frame_cfgs()
        pr = fm["bbox_head"]["voxel_generator"]["range"]
        gen = torch.Generator().manual_seed(SEED + 62)
        fdet = build_detector(fm, None, ftc, device=dev, generator=gen)
        randomize_norms(fdet.module, gen)
        ckpt = os.path.join(root, "ckpt")
        save_checkpoint(ckpt, 0, fdet.module.state_dict())
        depth = fdet.module.bbox_head.layer.depth
        del fdet
        val = write_val_set(root, np.random.RandomState(SEED + 62), pr,
                            DIST_FRAMES)
        eval_cfg = write_eval_config(root, val)
        args = [eval_cfg, "--checkpoint", os.path.join(ckpt, "latest"),
                "--max_points", str(EVAL_ROWS)]
        _, (_, plain_fps), plain_launches = counted(lambda: dist_test.main(
            args + ["--work_dir", os.path.join(root, "eval_plain")]))
        rec = torchrun(root, "dist_test", args + [
            "--work_dir", os.path.join(root, "eval_dist"), "--mesh",
            "data=1"])
        want = {"stem": DIST_FRAMES, "scatter_max": DIST_FRAMES,
                "swin_attn": depth * DIST_FRAMES, "swin_block": 0}
        if rec["launches"] != want or plain_launches != want:
            raise AssertionError(f"dist dist_test launches {rec['launches']}"
                                 f", without a group {plain_launches}")
        preds = []
        for sub in ("eval_plain", "eval_dist"):
            with open(os.path.join(root, sub, "prediction.pkl"), "rb") as f:
                preds.append(pickle.load(f))
        if list(preds[0]) != list(preds[1]) or len(preds[0]) != DIST_FRAMES:
            raise AssertionError(f"dist dist_test frames {list(preds[1])}")
        for token, d in preds[0].items():
            if not all(np.array_equal(preds[1][token][k], d[k]) for k in
                       ("box3d_lidar", "scores", "label_preds")):
                raise AssertionError(f"dist dist_test {token}: torchrun's "
                                     "prediction differs")
        log(f"dist (c): dist_test under torchrun (NCCL, world 1) over "
            f"{DIST_FRAMES} frames: every frame bit-equal to the run without "
            f"a group; launches {rec['launches']}; middle-third FPS "
            f"{rec['out']!r} (without a group {plain_fps!r}); whole run "
            f"{rec['wall_s']!r} s")

        train_info, db_info, _ = write_train_set(
            os.path.join(root, "train_set"), np.random.RandomState(SEED + 63),
            pr, DIST_TRAIN_FRAMES)
        cfg_path = write_train_config(root, train_info, val, db_info)
        with open(cfg_path, "a") as f:
            f.write(f"lr_config = {DIST_LR!r}\n"
                    f"optimizer = {DIST_OPTIMIZERS[2]!r}\n")
        work = os.path.join(root, "train_out")
        trec = torchrun(root, "train", [
            cfg_path, "--work_dir", work, "--batch_size", "4",
            "--total_steps", "2", "--max_points", str(TRAIN_ROWS),
            "--mesh", "data=1"])
        with open(os.path.join(work, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        sched = build_lr_schedule(DIST_LR, 2, steps_per_epoch=1)
        if trec["out"] != 2 or [r["step"] for r in recs] != [0, 1]:
            raise AssertionError(f"dist train CLI: {trec}, {recs}")
        for r in recs:
            vals = [r[k] for k in r if k.startswith("loss") or
                    k == "grad_norm"]
            if not all(np.isfinite(vals)) or r["lr"] != float(
                    sched(r["step"])):
                raise AssertionError(f"dist train CLI step {r}")
        want = {"stem": 0, "scatter_max": 2, "swin_attn": 0, "swin_block": 0}
        if trec["launches"] != want:
            raise AssertionError(f"dist train CLI launches "
                                 f"{trec['launches']}")
        log(f"dist (c): train CLI under torchrun (NCCL, world 1), adamw "
            f"under {DIST_LR}: losses "
            f"{[r['loss'] for r in recs]!r}, lr {[r['lr'] for r in recs]!r}"
            f" (the schedule's), launches {trec['launches']}, whole run "
            f"{trec['wall_s']!r} s")
    phase_s = time.perf_counter() - t_phase
    log(f"dist phase: {phase_s!r} s")
    return {"step": {"plain_ms": plain[1], "ddp_ms": ddp[1],
                     "firm_err": firm_err, "loose_share": loose_share,
                     "collectives": ddp[3][0], "launches": ddp[4],
                     "bit_equal": bit_equal},
            "family": family,
            "dist_test": {"launches": rec["launches"], "fps": rec["out"],
                          "plain_fps": plain_fps},
            "train_cli": {"launches": trec["launches"],
                          "wall_s": trec["wall_s"]},
            "phase_s": phase_s}


MESH_SPECS = ("model=2", "azimuth=2")   # two processes on the one card
MESH_EVAL_FRAMES = 8        # dist_test frames under each mesh
MESH_BLOCK_FRAMES = 2       # whole-block route frames under model=2
MESH_BATCH = 2              # the train step's batch: two ranks fit in 80 GB
# a kept row that overlaps a kept row of the other run this near the NMS
# threshold is a near-tie (:func:`mesh_same_kept`)
MESH_IOU_MARGIN = 0.02
# the share of elements where Adam's first step must be determined
# (tests/test_torch_dist.py's rule for a chaotic upstream network)
MESH_FIRM_SHARE = 0.5
_MESH_RUNNER = r"""
import os, sys
import torch
import torch.distributed as tdist
torch.cuda.set_device(0)
tdist.init_process_group(
    "gloo", init_method="tcp://%s:%s" % (os.environ["MASTER_ADDR"],
                                         os.environ["MASTER_PORT"]),
    rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
import chip_smoke
chip_smoke.mesh_rank(sys.argv[1], sys.argv[2])
tdist.destroy_process_group()
"""


def mesh_inputs(root, dev):
    """The mesh phase's shared inputs, made the same in every process:
    the flagship's seeded bf16 weights as a port checkpoint (written once,
    by the phase), its val set and eval config, the whole-block route's
    sweeps, the float32 train step's weights and batch, and CenterPoint's
    seeded weights and sweep."""
    from partner_tpu_torch.models import build_detector

    fm, ftc = frame_cfgs()
    pr = fm["bbox_head"]["voxel_generator"]["range"]
    sweeps = [synthetic_sweep(np.random.RandomState(SEED + 71 + i), pr,
                              N_POINTS) for i in range(MESH_BLOCK_FRAMES)]
    tm, ttc, _, lr_max = train_cfgs(compute_dtype="float32")
    grid = tuple(int(round((pr[3 + i] - pr[i]) / v)) for i, v in
                 enumerate(tm["bbox_head"]["voxel_generator"]["voxel_size"]))
    batch = to_device(train_example(np.random.RandomState(SEED + 72), pr,
                                    grid, MESH_BATCH, TRAIN_POINTS,
                                    TRAIN_ROWS, MAX_BOXES), dev)
    cm, _, ctc = centerpoint_cfgs()
    cpr = cm["bbox_head"]["voxel_generator"]["range"]
    cp_sweep = synthetic_sweep(np.random.RandomState(SEED + 73), cpr,
                               N_POINTS)

    def seeded(m, tc, seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        det = build_detector(m, None, tc, device=dev, generator=gen, **kw)
        randomize_norms(det.module, gen)
        return det

    return dict(
        eval_cfg=os.path.join(root, "eval_cfg.py"),
        ckpt=os.path.join(root, "ckpt", "latest"),
        block=lambda: seeded(fm, ftc, SEED + 70, use_block_kernel=True),
        frame=lambda: seeded(fm, ftc, SEED + 70),
        sweeps=sweeps, train=lambda: seeded(tm, ttc, SEED + 74),
        batch=batch, lr_max=lr_max, cp=lambda: seeded(cm, ctc, SEED + 75),
        cp_sweep=cp_sweep)


def mesh_tasks(spec, root, dev):
    """Every path of the mesh phase for ``spec`` in this process (one
    process without a group: the references) -> {path: record}. Each path
    is :func:`counted` (launches set to 0 just before it, read just after)
    and records its host ms, the collectives it issued, its peak memory
    and its outputs on the CPU; the train step's state after it is
    gathered whole."""
    from partner_tpu_torch.parallel import dist, mesh, tp
    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    inp = mesh_inputs(root, dev)
    one = spec == "one"
    axes = (1, 1, 1) if one else mesh.parse_mesh_spec(
        spec, torch.distributed.get_world_size())
    out = {}

    def record(name, fn):
        n0 = dist.counts["collectives"]
        torch.cuda.reset_peak_memory_stats()
        ms, res, counts = counted(fn)
        out[name] = {"ms": ms, "launches": counts, "result": res,
                     "collectives": dist.counts["collectives"] - n0,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        return res

    work = os.path.join(root, f"eval_{spec}")
    record("dist_test", lambda: dist_test.main([
        inp["eval_cfg"], "--checkpoint", inp["ckpt"], "--max_points",
        str(EVAL_ROWS), "--work_dir", work, "--device", dev.type] + (
            [] if one else ["--mesh", spec]))[1])
    out["dist_test"]["predictions"] = os.path.join(work, "prediction.pkl")

    def frames(det, sweeps):   # the checkpoint's weights, seeded alike
        mesh.place(det, mesh.build(*axes))
        return [{k: v.cpu() for k, v in det.predict(to_device(
            {"points": p, "points_mask": m}, dev)).items()}
            for p, m in sweeps]

    if "model" in spec or one:
        record("block", lambda: frames(inp["block"](), inp["sweeps"]))
    det = inp["train"]()
    grid = mesh.build(*axes)
    mesh.place(det, grid)
    step = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max=inp["lr_max"], total_steps=1000))
    drops = lambda: torch.Generator().manual_seed(SEED + 76)
    met = record("train", lambda: step(inp["batch"], drops()))
    out["train"]["result"] = {k: float(v) for k, v in met.items()}
    out["train"]["state"] = {k: v.float().cpu().clone() for k, v in
                             tp.full_state_dict(det.module).items()}
    out["train"]["grads"] = {k: tp.whole(p, p.grad).float().cpu().clone()
                             for k, p in det.module.named_parameters()
                             if p.grad is not None}
    out["train"]["second_ms"] = counted(lambda: step(inp["batch"],
                                                     drops()))[0]
    del det, step
    if "azimuth" in spec or one:
        def cp_frame():
            det = inp["cp"]()
            mesh.place(det, mesh.build(*axes))
            p, m = inp["cp_sweep"]
            return {k: v.cpu() for k, v in det.predict(to_device(
                {"points": p, "points_mask": m}, dev)).items()}
        record("cp", cp_frame)
    out["peak_gib"] = {k: v["peak_gib"] for k, v in out.items()}
    return out


def mesh_rank(spec, root, dev=torch.device("cuda", 0)):
    """A rank of the mesh phase's torchrun launch: :func:`mesh_tasks` of
    ``spec`` on the group the runner made, saved for the phase."""
    rank = torch.distributed.get_rank()
    # main()'s flags: full-f32 products wherever a reference computes f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = mesh_tasks(spec, root, dev)
    out["jax"] = [m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
    out["backend"] = torch.distributed.get_backend()
    torch.save(out, os.path.join(root, f"mesh_{spec}_rank{rank}.pt"))


def mesh_launch(root, spec, timeout=600):
    """:func:`mesh_rank` of ``spec`` on two processes of the one card
    through ``python -m torch.distributed.run --standalone
    --nproc_per_node 2`` -> each rank's record, and the launch's wall s."""
    runner = os.path.join(root, "mesh_runner.py")
    with open(runner, "w") as f:
        f.write(_MESH_RUNNER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", runner, spec, root], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"mesh {spec} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    recs = [torch.load(os.path.join(root, f"mesh_{spec}_rank{r}.pt"),
                       weights_only=False) for r in range(2)]
    for r in recs:
        if r["jax"] or r["backend"] != "gloo":
            raise AssertionError(f"mesh {spec}: {r['jax']} {r['backend']}")
    return recs, wall


def bev_iou_matrix(a, b):
    """(n, 7) and (m, 7) boxes (numpy) -> their (n, m) rotated BEV IoU, as
    the NMS computes it (``ops.nms.suppression_matrix``)."""
    from partner_tpu_torch.ops.rotated_iou import (
        rect_intersection_area_green_pretrig)

    a, b = (torch.from_numpy(np.asarray(x, np.float32)[:, [0, 1, 3, 4, 6]])
            for x in (a, b))
    trig = lambda x: torch.stack([torch.cos(x[:, 4]), torch.sin(x[:, 4])], -1)
    inter = rect_intersection_area_green_pretrig(
        a[:, None], b[None], trig(a)[:, None], trig(b)[None])
    area = lambda x: x[:, 2] * x[:, 3]
    union = torch.clamp(area(a)[:, None] + area(b)[None] - inter, min=1e-8)
    return (inter / union).numpy()


def mesh_same_kept(got, want, tag, iou_threshold):
    """One frame's kept boxes (``kept_boxes``) of a mesh run against the
    one-process run's: the same count, and every row matched by a row of
    the same label whose box and score lie within KERNEL_TOL (1 + |value|),
    but near-ties, which a rounding of the score or the box may decide
    either way: a row whose score lies within twice that bound of both
    runs' lowest kept scores (the kept cut), or that overlaps a kept row
    of the other run at a BEV IoU above ``iou_threshold`` -
    MESH_IOU_MARGIN (the NMS suppressing one of the two, or not). ->
    (rows matched at their own place, near-ties, rows)."""
    n = len(want["scores"])
    if len(got["scores"]) != n:
        raise AssertionError(f"{tag}: kept {len(got['scores'])} != {n}")
    tol = lambda a: KERNEL_TOL * (1 + np.abs(a))
    free = set(range(n))
    left, at_place = [], 0
    for i in range(n):
        ok = [k for k in free
              if got["label_preds"][i] == want["label_preds"][k]
              and np.all(np.abs(got["box3d_lidar"][i] - want["box3d_lidar"][k])
                         <= tol(want["box3d_lidar"][k]))
              and abs(got["scores"][i] - want["scores"][k])
              <= tol(want["scores"][k])]
        if not ok:
            left.append(i)
            continue
        k = i if i in ok else ok[0]
        at_place += int(k == i)
        free.discard(k)
    near = 0
    lows = [run["scores"].min() for run in (got, want)] if n else []
    for run, other, rows in ((got, want, left), (want, got, sorted(free))):
        if not rows:
            continue
        iou = bev_iou_matrix(run["box3d_lidar"][rows], other["box3d_lidar"])
        for j, i in enumerate(rows):
            if (all(abs(run["scores"][i] - low) <= 2 * tol(low)
                    for low in lows)
                    or iou[j].max() > iou_threshold - MESH_IOU_MARGIN):
                near += 1
                continue
            raise AssertionError(
                f"{tag}: kept row {i} (score {run['scores'][i]!r}) matches "
                f"no row and is no near-tie (largest IoU with the other "
                f"run's kept rows {iou[j].max()!r})")
    return at_place, near, n


def mesh_kept(pairs, tag, iou_threshold):
    """:func:`mesh_same_kept` over (mesh, one process) kept-box pairs of
    frames -> the summed (at place, near-ties, rows)."""
    tot = np.zeros(3, int)
    for i, (got, want) in enumerate(pairs):
        tot += mesh_same_kept(got, want, f"{tag} frame {i}", iou_threshold)
    return tuple(int(x) for x in tot)


def mesh_phase(dev, card):
    """The mesh's model and azimuth axes on the one card: two processes
    over a gloo group (NCCL refuses two ranks on one device) under
    ``python -m torch.distributed.run --nproc_per_node 2``, at
    ``--mesh model=2`` and at ``--mesh azimuth=2``, each rank on cuda:0.
    Each rank runs (:func:`mesh_tasks`) the flagship's ``dist_test`` over
    MESH_EVAL_FRAMES synthetic 180,000-point frames from a seeded bf16
    checkpoint; under model=2 the whole-block route on MESH_BLOCK_FRAMES
    sweeps; one float32 flagship train step at batch MESH_BATCH from
    seeded weights; under azimuth=2 one CenterPoint frame. This process
    runs the same paths without a group first, the references. Held: the
    kept boxes of every frame (:func:`mesh_same_kept`), the train step
    (:func:`mesh_step_check`: loss terms, gradients, parameters after
    Adam), and each rank's launches: the stem, scatter-max,
    attention and block kernels where their path runs them. Prints the
    launches per rank, the collectives a path, ms a frame and a step
    (smoke readings: two processes share one card), the peak memory per
    rank, beside the card's name and power limit."""
    import pickle
    import tempfile

    from partner_tpu_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    out = {}
    thr = frame_cfgs()[1]["nms"]["nms_iou_threshold"]
    cp_thr = centerpoint_cfgs()[2]["nms"]["nms_iou_threshold"]
    with tempfile.TemporaryDirectory() as root:
        fm, _ = frame_cfgs()
        pr = fm["bbox_head"]["voxel_generator"]["range"]
        det = mesh_inputs(root, dev)["frame"]()
        depth = det.module.bbox_head.layer.depth   # the head's Swin blocks
        save_checkpoint(os.path.join(root, "ckpt"), 0,
                        det.module.state_dict())
        write_eval_config(root, write_val_set(
            root, np.random.RandomState(SEED + 77), pr, MESH_EVAL_FRAMES))
        del det
        one = mesh_tasks("one", root, dev)
        torch.cuda.empty_cache()
        with open(one["dist_test"]["predictions"], "rb") as f:
            want_preds = pickle.load(f)
        for spec in MESH_SPECS:
            recs, wall = mesh_launch(root, spec)
            with open(recs[0]["dist_test"]["predictions"], "rb") as f:
                preds = pickle.load(f)
            if list(preds) != list(want_preds):
                raise AssertionError(f"mesh {spec}: frames {list(preds)}")
            at, near, rows = mesh_kept(
                [(preds[t], w) for t, w in want_preds.items()],
                f"{spec} dist_test", thr)
            res = {"wall_s": wall, "kept": (at, near, rows),
                   "peak_gib": [r["peak_gib"] for r in recs],
                   "dist_test": {
                       "launches": [r["dist_test"]["launches"]
                                    for r in recs],
                       "ms_frame": [r["dist_test"]["ms"] / MESH_EVAL_FRAMES
                                    for r in recs],
                       "collectives": [r["dist_test"]["collectives"]
                                       for r in recs]}}
            want_eval = {"stem": MESH_EVAL_FRAMES,
                         "scatter_max": MESH_EVAL_FRAMES,
                         "swin_attn": depth * MESH_EVAL_FRAMES,
                         "swin_block": 0}
            checks = [("dist_test", want_eval)]
            if "block" in recs[0]:
                kb = mesh_kept([(kept_boxes(r["block"]["result"][i]),
                                 kept_boxes(w)) for r in recs for i, w in
                                enumerate(one["block"]["result"])],
                               f"{spec} block", thr)
                res["block"] = {"kept": kb, "launches": [
                    r["block"]["launches"] for r in recs], "ms_frame": [
                    r["block"]["ms"] / MESH_BLOCK_FRAMES for r in recs]}
                checks.append(("block", {
                    "stem": MESH_BLOCK_FRAMES,
                    "scatter_max": MESH_BLOCK_FRAMES, "swin_attn": 0,
                    "swin_block": depth * MESH_BLOCK_FRAMES}))
            if "cp" in recs[0]:
                kc = mesh_kept([(kept_boxes(recs[0]["cp"]["result"]),
                                 kept_boxes(one["cp"]["result"]))],
                               f"{spec} CenterPoint", cp_thr)
                res["cp"] = {"kept": kc, "launches": [
                    r["cp"]["launches"] for r in recs], "ms": [
                    r["cp"]["ms"] for r in recs]}
                checks.append(("cp", {"stem": 1, "scatter_max": 1,
                                      "swin_attn": 0, "swin_block": 0}))
            checks.append(("train", {"stem": 0, "scatter_max": 1,
                                     "swin_attn": 0, "swin_block": 0}))
            for path, want in checks:
                for rank, r in enumerate(recs):
                    if r[path]["launches"] != want:
                        raise AssertionError(
                            f"mesh {spec} {path} rank {rank}: launches "
                            f"{r[path]['launches']} != {want}")
            res["train"] = mesh_step_check(spec, recs, one["train"])
            out[spec] = res
            log(f"mesh {spec} on {card}: two processes over gloo, whole "
                f"launch {wall!r} s, peak per rank {res['peak_gib']!r} GiB "
                f"(one process {one['peak_gib']!r}); dist_test over "
                f"{MESH_EVAL_FRAMES} frames: kept rows {at} of {rows} "
                f"matched at their place, {near} near-ties (at the kept cut "
                f"or the NMS threshold), the rest within KERNEL_TOL of "
                f"another row; launches per "
                f"rank {res['dist_test']['launches']}, collectives per rank "
                f"{res['dist_test']['collectives']}, ms a frame per rank "
                f"{res['dist_test']['ms_frame']!r} (one process "
                f"{one['dist_test']['ms'] / MESH_EVAL_FRAMES!r})")
            if "block" in res:
                log(f"mesh {spec} whole-block route on {card}: kept rows "
                    f"(at place, near-ties, all) {res['block']['kept']}, "
                    f"launches per rank {res['block']['launches']}, ms a "
                    f"frame per rank {res['block']['ms_frame']!r}")
            if "cp" in res:
                log(f"mesh {spec} CenterPoint frame on {card}: kept rows (at "
                    f"place, near-ties, all) {res['cp']['kept']}, "
                    f"launches per rank {res['cp']['launches']}, ms per rank "
                    f"{res['cp']['ms']!r}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['phase_s']!r} s")
    return out


def mesh_step_check(spec, recs, one):
    """The mesh's train step (rank 0's; every rank's metrics alike) against
    the one-process step, at the float32 train reference's bounds: the
    loss terms within TRAIN_F32_LOSS_TOL, the gradients by top-level
    module within TRAIN_F32_GRAD_TOL relative RMS (the upstream network is
    chaotic at random weights: a summation order moves its gradients by a
    percent), the parameters after Adam within 2e-6 where its first step
    is determined (the clipped gradients agree within 1% and stand clear
    of eps by DIST_ADAM_CLEAR), on at least MESH_FIRM_SHARE of the
    elements, and within 2 lr everywhere; the statistics within
    TRAIN_F32_LOSS_TOL relative RMS."""
    got, want = recs[0]["train"], one
    for r in recs[1:]:
        if r["train"]["result"] != got["result"]:
            raise AssertionError(f"mesh {spec} train: ranks disagree")
    lv, pv = got["result"], want["result"]
    bad = {}
    loss_err = {k: abs(lv[k] - pv[k]) / abs(pv[k]) for k in pv
                if k.startswith("loss")}
    bad.update({k: e for k, e in loss_err.items()
                if not e <= TRAIN_F32_LOSS_TOL})
    gerr = grad_errors(got["grads"], want["grads"])
    bad.update({f"grad {k}": e for k, (e, _) in gerr.items()
                if not e <= TRAIN_F32_GRAD_TOL[k]})
    _, _, _, lr_max = train_cfgs()
    lr0 = lr_max / 10.0
    clip = min(1.0, DIST_GRAD_CLIP / pv["grad_norm"])
    firm_err = moved = 0.0
    n_firm = n_all = 0
    for k, g in want["grads"].items():
        d = (got["state"][k] - want["state"][k]).abs()
        gm, gp = got["grads"][k] * clip, g * clip
        firm = ((gp.abs() > DIST_ADAM_CLEAR)
                & ((gm - gp).abs() <= 1e-2 * gp.abs()))
        moved = max(moved, float(d.max()))
        if firm.any():
            firm_err = max(firm_err, float(
                (d[firm] - 1e-6 * want["state"][k][firm].abs()).max()))
        n_firm += int(firm.sum())
        n_all += firm.numel()
    share = n_firm / n_all
    stat_err = max([rel_rms_of(k, got["state"][k], t)[0] for k, t in
                    want["state"].items() if k not in want["grads"]
                    and not torch.equal(got["state"][k], t)], default=0.0)
    if not moved <= 2 * lr0 * 1.01:
        bad["parameters"] = moved
    if not firm_err <= 2e-6:
        bad["parameters where the step is determined"] = firm_err
    if not share >= MESH_FIRM_SHARE:
        bad["share of determined elements"] = share
    if not stat_err <= TRAIN_F32_LOSS_TOL:
        bad["statistics"] = stat_err
    bit_equal = all(torch.equal(got["state"][k], t)
                    for k, t in want["state"].items())
    res = {"loss_err": loss_err, "grad_err": gerr, "firm_err": firm_err,
           "firm_share": share, "stat_err": stat_err, "bit_equal": bit_equal,
           "ms": [r["train"]["ms"] for r in recs],
           "second_ms": [r["train"]["second_ms"] for r in recs],
           "one_ms": (want["ms"], want["second_ms"]),
           "collectives": [r["train"]["collectives"] for r in recs],
           "launches": [r["train"]["launches"] for r in recs]}
    log(f"mesh {spec} float32 flagship train step at batch {MESH_BATCH}: "
        f"loss terms' relative errors against one process {loss_err} "
        f"(bound {TRAIN_F32_LOSS_TOL}), grad relative RMS and norm ratio by "
        f"module {gerr} (bounds {TRAIN_F32_GRAD_TOL}), parameters after "
        f"Adam within {firm_err!r} beyond 1e-6 relative where its step is "
        f"determined (bound 2e-6), on {share!r} of the elements (bound "
        f"{MESH_FIRM_SHARE}), all within {moved!r} (bound 2 lr), "
        f"statistics relative RMS {stat_err!r}; bit-equal {bit_equal}; "
        f"collectives a step per rank {res['collectives']}, ms per rank "
        f"{res['ms']!r} then {res['second_ms']!r} (one process "
        f"{res['one_ms']!r}); launches per rank {res['launches']}")
    if bad:
        raise AssertionError(f"mesh {spec} train step beyond its bounds: "
                             f"{bad}")
    return res


TOOLS_FRAMES = 10            # one sequence of fake Waymo frames (cut first)
TOOLS_OBJECTS = 40           # moving boxes a frame
TOOLS_EGO_STEP = 2.0         # metres the ego drives a frame: 20 m/s at 10 Hz
FRAME_S = 0.1                # seconds between two Waymo frames
CSWIN_SHAPE = (1, 144, 256, 256)   # the flagship's BEV map, NHWC
CSWIN_HEADS = 8
CSWIN_SPLIT = 8              # the last stage's windows (144 = 18 x 8)
CSWIN_TOL = 1e-5             # relative RMS, card against CPU, float32
CSWIN_TIMED = 5              # timed calls of each stage kind
FLOPS_TIMED = 5              # timed flagship frames for the MFU
WAYMO_KINDS = {1: 0, 2: 1, 4: 2}   # Waymo type -> tracker label


def moving_objects(rng, n):
    """``n`` objects of the three classes in turn, each at a constant
    global velocity: (Waymo type, dims, start (n, 3) global at frame 0 =
    the sensor frame then, velocity (n, 2) m/s)."""
    kinds = [(1, 2, 4)[j % 3] for j in range(n)]
    rho = rng.uniform(8.0, 45.0, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    # centres 0.5 m up: the boxes hold the ground's returns (z ~ 0)
    start = np.stack([rho * np.cos(phi), rho * np.sin(phi),
                      np.full(n, 0.5)], 1)
    speed = np.array([{1: rng.uniform(5, 12), 2: rng.uniform(1, 2),
                       4: rng.uniform(3, 6)}[k] for k in kinds])
    head = rng.uniform(-np.pi, np.pi, n)
    vel = np.stack([speed * np.cos(head), speed * np.sin(head)], 1)
    return kinds, start, vel


def tracked_frames(rng, n_frames, n_objects):
    """:func:`fake_waymo_frame`\\ s of one sequence, the ego driving
    TOOLS_EGO_STEP m a frame along x, each labelled with the same
    ``n_objects`` moving objects (ids ``obj{j}``; ``speed_x`` / ``speed_y``
    their global m/s, which the decoder turns into the vehicle frame) ->
    (frames, {frame: (global centers (n, 3), tracker labels, ids)})."""
    kinds, start, vel = moving_objects(rng, n_objects)
    frames, truth = [], {}
    for f in range(n_frames):
        fr = fake_waymo_frame(rng, f, n_objects, ego_step=TOOLS_EGO_STEP)
        glob = start.copy()
        glob[:, :2] += vel * f * FRAME_S
        local = glob - np.array([TOOLS_EGO_STEP * f, 0.0, 0.0])
        fr["laser_labels"] = [{
            "id": f"obj{j}", "type": k,
            "box": {"center_x": local[j, 0], "center_y": local[j, 1],
                    "center_z": local[j, 2], "length": TS_SIZES[k][1][0],
                    "width": TS_SIZES[k][1][1], "height": TS_SIZES[k][1][2],
                    "heading": float(np.arctan2(vel[j, 1], vel[j, 0]))},
            "metadata": {"speed_x": vel[j, 0], "speed_y": vel[j, 1],
                         "accel_x": 0.0, "accel_y": 0.0},
            "num_lidar_points_in_box": 10,
            "detection_difficulty_level": 0} for j, k in enumerate(kinds)]
        frames.append(fr)
        truth[f] = (glob, np.array([WAYMO_KINDS[k] for k in kinds]),
                    np.arange(n_objects))
    return frames, truth


def cswin_reading(dev, card):
    """``CSWinBlock`` at the flagship BEV, CSWIN_SHAPE, CSWIN_HEADS heads,
    float32, seeded weights and a polar grid's cell centres as ``pos``:
    the row and column stripes, and the last stage's CSWIN_SPLIT x
    CSWIN_SPLIT windows; each the card against the CPU (relative RMS
    within CSWIN_TOL), the median of CSWIN_TIMED calls and the peak
    memory of one call."""
    from partner_tpu_torch.models.cswin import CSWinBlock
    from partner_tpu_torch.models.layers import init_weights

    b, h, w, c = CSWIN_SHAPE
    gen = torch.Generator().manual_seed(SEED + 71)
    x = torch.randn(CSWIN_SHAPE, generator=gen)
    az = (torch.arange(h) + 0.5) / h * 2 * np.pi - np.pi
    r = (torch.arange(w) + 0.5) / w * 75.0
    pos = torch.stack([r[None, :] * torch.cos(az[:, None]),
                       r[None, :] * torch.sin(az[:, None])], -1)
    out = {}
    for kind, last in (("rows_cols", False), ("last_stage", True)):
        blk = CSWinBlock(c, CSWIN_HEADS, split_size=CSWIN_SPLIT,
                         last_stage=last)
        with torch.no_grad():
            init_weights(blk, gen)
            for p in blk.parameters():   # norms and biases off their init
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
            want = blk(x, pos)
            card_blk = blk.to(dev)
            xd, pd = x.to(dev), pos.to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got = card_blk(xd, pd)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rel_rms(f"CSWin {kind}", got, want, CSWIN_TOL)
            ms = cuda_ms(lambda: card_blk(xd, pd), reps=CSWIN_TIMED,
                         warmup=1)
        out[kind] = dict(ms=ms, peak_gib=peak,
                         rel_rms=rel_rms_of(kind, got, want)[0])
        log(f"tools: CSWinBlock {kind} at {CSWIN_SHAPE}, {CSWIN_HEADS} heads, "
            f"float32 on {card}: median {ms!r} ms of {CSWIN_TIMED} calls, "
            f"peak {peak!r} GiB")
        del card_blk, got
    return out


def flops_reading(dev, card):
    """``tools.flops_report`` on the flagship at full size on the card (the
    kernel route, charged by the wrappers) and with ``--device cpu`` (the
    plain twins, counted by the counter; its seconds are logged): the two
    tables and totals equal; the MFU of the median of
    FLOPS_TIMED timed frames (after one warm-up) of the same detector and
    sweep against ``utils.flops.device_peak_flops()``."""
    from partner_tpu_torch.tools import flops_report
    from partner_tpu_torch.utils.flops import device_peak_flops, mfu

    argv = ["--config", CONFIG, "--points", str(N_POINTS), "--device"]
    _, (tbl, total), launches = counted(
        lambda: flops_report.main(argv + [dev.type]))
    if launches != {"stem": 1, "scatter_max": 1, "swin_attn": 2,
                    "swin_block": 0}:
        raise AssertionError(f"flops_report launches {launches}")
    t_cpu = time.perf_counter()
    _, (plain_tbl, plain_total), plain_launches = counted(
        lambda: flops_report.main(argv + ["cpu"]))
    t_cpu = time.perf_counter() - t_cpu
    if any(plain_launches.values()):
        raise AssertionError(f"plain route launched {plain_launches}")
    if plain_total != total or plain_tbl != tbl:
        raise AssertionError(f"FLOPs: kernel route {total}, plain route "
                             f"{plain_total}")
    det, ex = flops_report.build_frame(CONFIG, N_POINTS, dev)
    times = []
    with torch.no_grad():
        for i in range(FLOPS_TIMED + 1):
            ms, _, _ = counted(lambda: det.predict(ex))
            if i:
                times.append(ms)
    median = statistics.median(times)
    peak = device_peak_flops()
    util = mfu(total, median / 1e3)
    log(f"tools: flops_report on {card}: {total / 1e9!r} GFLOP a frame on "
        f"the card and the CPU (kernel charges and plain twins equal; the "
        f"CPU's count {t_cpu!r} s); frame median {median!r} ms of "
        f"{FLOPS_TIMED}, MFU {util!r} against {peak!r} FLOP/s bf16 "
        f"({torch.cuda.get_device_name(0)})")
    return dict(gflop=total / 1e9, median_ms=median, mfu=util, peak=peak,
                cpu_count_s=t_cpu, launches=launches, modules=len(tbl))


def tools_phase(dev, card):
    """The host tools and the FLOP counter of the port on the card's
    machine (no JAX): (a) TOOLS_FRAMES fake Waymo frames of one sequence
    (:func:`tracked_frames`: TOOLS_OBJECTS moving boxes, ``veh_to_global``
    in the annos, no ``pose`` in the infos) through ``create_data``, then
    ``dist_test`` of the flagship (bf16, seeded weights) over them on the
    card and ``tools.track`` over its predictions; (b) the ground-truth
    boxes with their true velocities as detections: ``tools.track`` to
    MOTA 1.0 with no id switch against the objects' own global tracks, and
    a 2 x 2 ``track_line_search``; (c) ``nms_ensemble`` of the dist_test
    predictions and a seeded perturbed copy on the card, each frame's kept
    boxes equal to ``--device cpu``'s; (d) ``CSWinBlock`` at full width
    (:func:`cswin_reading`); (e) ``flops_report`` (:func:`flops_reading`);
    (f) ``write_ply_scene``, ``box_corners_bev`` and
    ``generate_instance_ids`` on a frame, and the demo CLI where
    matplotlib is installed."""
    import importlib.util
    import pickle
    import tempfile

    from partner_tpu_torch.eval.tracking import mota_evaluate
    from partner_tpu_torch.tools import (create_data, demo, dist_test,
                                         generate_instance_ids, nms_ensemble,
                                         track, track_line_search)
    from partner_tpu_torch.utils.viz3d import write_ply_scene

    t_phase = time.perf_counter()
    res = {}
    rng = np.random.RandomState(SEED + 70)
    with tempfile.TemporaryDirectory() as root:
        frames, truth = tracked_frames(rng, TOOLS_FRAMES, TOOLS_OBJECTS)
        record = os.path.join(root, "records.pkl")
        with open(record, "wb") as f:
            pickle.dump(frames, f)
        del frames
        create_data.main(["waymo_convert", "--record_path", record,
                          "--root_path", root, "--split", "val"])
        info_path = create_data.main(["waymo_data_prep", "--root_path", root,
                                      "--split", "val"])
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        if len(infos) != TOOLS_FRAMES or any("pose" in i for i in infos):
            raise AssertionError(f"tools: {len(infos)} infos")

        # (a) dist_test on the card, then the tracker over its boxes
        cfg_path = write_eval_config(root, info_path)
        wd = os.path.join(root, "eval")
        _, _, dt_launches = counted(lambda: dist_test.main([
            cfg_path, "--work_dir", wd, "--max_points", str(EVAL_ROWS),
            "--device", dev.type]))
        want = {"stem": TOOLS_FRAMES, "swin_attn": 2 * TOOLS_FRAMES,
                "scatter_max": TOOLS_FRAMES, "swin_block": 0}
        if dt_launches != want:
            raise AssertionError(f"tools dist_test launches {dt_launches}")
        pred_path = os.path.join(wd, "prediction.pkl")
        with open(pred_path, "rb") as f:
            preds = pickle.load(f)
        t0 = time.perf_counter()
        tracked = track.main(["--prediction", pred_path, "--info_path",
                              info_path, "--work_dir",
                              os.path.join(root, "track"),
                              "--score_thresh", "0"])
        track_ms = (time.perf_counter() - t0) * 1e3 / TOOLS_FRAMES
        n_tracked = sum(len(r["tracking_ids"]) for r in tracked.values())
        n_ids = len({int(i) for r in tracked.values()
                     for i in r["tracking_ids"]})
        boxes = sum(len(p["scores"]) for p in preds.values())
        if len(tracked) != TOOLS_FRAMES or not n_tracked:
            raise AssertionError(f"tools: tracked {n_tracked} boxes")
        log(f"tools (a): dist_test of the flagship over {TOOLS_FRAMES} fake "
            f"frames on {card}, launches {dt_launches}; track (poses from "
            f"veh_to_global, --score_thresh 0): {n_tracked} tracked boxes of "
            f"{boxes}, {n_ids} track ids, {track_ms!r} ms a frame")
        res["dist_test"] = dict(launches=dt_launches, tracked=n_tracked,
                                ids=n_ids, boxes=boxes, track_ms=track_ms)

        # (b) ground truth as detections: MOTA 1.0, then the line search
        names = ("Vehicle", "Pedestrian", "Cyclist")
        by_token = {i["token"]: i for i in infos}
        gt_dets, gt_frames = {}, {}
        for f in range(TOOLS_FRAMES):
            tok = f"seq_0_frame_{f}"
            gt = by_token[tok]["gt_boxes"].copy()
            # the infos' timestamp counts frames (ROADMAP.md §3): the
            # velocities go in metres a frame
            gt[:, 6:8] *= FRAME_S
            gt_dets[tok] = {"box3d_lidar": gt,
                            "scores": np.ones(len(gt), np.float32),
                            "label_preds": np.array(
                                [names.index(n) for n in
                                 by_token[tok]["gt_names"]])}
            centers, labels, ids = truth[f]
            gt_frames[tok] = {"centers": centers, "labels": labels,
                              "ids": ids}
        paths = {}
        for name, obj in (("gt_dets", gt_dets), ("gt_frames", gt_frames)):
            paths[name] = os.path.join(root, f"{name}.pkl")
            with open(paths[name], "wb") as f:
                pickle.dump(obj, f)
        gt_tracked = track.main(["--prediction", paths["gt_dets"],
                                 "--info_path", info_path, "--work_dir",
                                 os.path.join(root, "track_gt")])
        m = mota_evaluate(gt_tracked, gt_frames)
        if m["mota"] != 1.0 or m["id_switches"]:
            raise AssertionError(f"tools: ground-truth tracking {m}")
        best = track_line_search.main([
            "--prediction", paths["gt_dets"], "--info_path", info_path,
            "--gt_path", paths["gt_frames"], "--scores", "0.5:0.8:0.3",
            "--dists", "1.0:3.0:2.0"])
        if best[0] != 1.0:
            raise AssertionError(f"tools: line search best {best}")
        log(f"tools (b): ground truth ({TOOLS_OBJECTS} objects x "
            f"{TOOLS_FRAMES} frames, ego {TOOLS_EGO_STEP} m a frame) as "
            f"detections: MOTA {m['mota']!r}, {m['id_switches']} id "
            f"switches, {m['num_gt']} ground-truth boxes; 2 x 2 line search "
            f"best MOTA {best[0]!r} at score {best[1]!r}, dist {best[2]!r}")
        res["mota"] = m

        # (c) the NMS ensemble on the card against the CPU
        prng = np.random.RandomState(SEED + 72)
        other = {}
        for tok, p in preds.items():
            b = np.array(p["box3d_lidar"], np.float32)
            b[:, :2] += prng.randn(len(b), 2).astype(np.float32) * 0.2
            other[tok] = {"box3d_lidar": b,
                          "scores": p["scores"] * prng.uniform(
                              0.8, 1.2, len(b)).astype(np.float32),
                          "label_preds": p["label_preds"]}
        other_path = os.path.join(root, "other.pkl")
        with open(other_path, "wb") as f:
            pickle.dump(other, f)
        out = {}
        for d in (dev.type, "cpu"):
            t0 = time.perf_counter()
            out[d] = nms_ensemble.main([os.path.join(root, f"ens_{d}.pkl"),
                                        pred_path, other_path, "--weights",
                                        "1.0", "0.8", "--device", d])
            out[d + "_ms"] = (time.perf_counter() - t0) * 1e3 / len(preds)
        card_out = out[dev.type]
        bad = [tok for tok in preds if any(
            not np.array_equal(card_out[tok][k], out["cpu"][tok][k])
            for k in ("box3d_lidar", "scores", "label_preds"))]
        kept = sum(len(v["scores"]) for v in card_out.values())
        if bad or sorted(card_out) != sorted(out["cpu"]):
            raise AssertionError(f"nms_ensemble: frames {bad} differ "
                                 "between the card and the CPU")
        log(f"tools (c): nms_ensemble of {len(preds)} frames x 2 models "
            f"({2 * boxes} boxes) on {card}: {kept} kept, every frame equal "
            f"to --device cpu; {out[dev.type + '_ms']!r} ms a frame on the "
            f"card, {out['cpu_ms']!r} on the CPU")
        res["ensemble"] = dict(kept=kept, ms=out[dev.type + "_ms"],
                               cpu_ms=out["cpu_ms"])

        # (d), (e)
        res["cswin"] = cswin_reading(dev, card)
        res["flops"] = flops_reading(dev, card)

        # (f) host tools on the first frame
        info = infos[0]
        with open(info["path"], "rb") as f:
            lidars = pickle.load(f)["lidars"]
        pts = np.concatenate([lidars["points_xyz"],
                              lidars["points_feature"]], 1)
        det0 = preds[info["token"]]
        ply = write_ply_scene(os.path.join(root, "scene.ply"), pts,
                              det_boxes=det0["box3d_lidar"][:20],
                              gt_boxes=info["gt_boxes"])
        corners = demo.box_corners_bev(info["gt_boxes"])
        labelled = [dict(info, points=pts,
                         points_label=np.ones(len(pts), np.int64))]
        lab_path = os.path.join(root, "labelled.pkl")
        with open(lab_path, "wb") as f:
            pickle.dump(labelled, f)
        inst = generate_instance_ids.main([
            "--info_path", lab_path, "--out",
            os.path.join(root, "instance_ids.pkl")])[info["token"]]
        if corners.shape != (TOOLS_OBJECTS, 4, 2) or not np.isfinite(
                corners).all():
            raise AssertionError(f"box_corners_bev {corners.shape}")
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        if has_mpl:
            written = demo.main(["--prediction", pred_path, "--info_path",
                                 info_path, "--out_dir",
                                 os.path.join(root, "demo"),
                                 "--max_frames", "1"])
            demo_note = f"demo CLI wrote {written}"
        else:
            demo_note = "matplotlib not installed: the demo CLI not run"
        log(f"tools (f): write_ply_scene {os.path.getsize(ply)} bytes "
            f"({len(pts)} points, 20 + {TOOLS_OBJECTS} boxes); "
            f"box_corners_bev {corners.shape}; generate_instance_ids "
            f"{int((inst > 0).sum())} points in {len(set(inst.tolist())) - 1}"
            f" boxes; {demo_note}")
        res["host"] = dict(ply_bytes=os.path.getsize(ply),
                           instance_points=int((inst > 0).sum()),
                           demo=has_mpl)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"tools phase: {res['phase_s']!r} s")
    return res


# ---------------------------------------------------------------- box coders

CODER_TEMPLATE = [2.0, 4.5, 1.6]   # a vehicle's dx, dy, dz (dy >= dx)
# the six variant coders of CODER_CONFIG["type"] and the arguments each
# runs with here (the flagship's own CenterCoder is the other phases')
CODER_VARIANTS = {
    "CenterCoderV2": dict(rectify=False),
    "CenterCoderPolar": dict(rectify=True),
    "CenterCoderPolarTP": dict(template_ratio=2.25),
    "CenterCoderPolarSIG": dict(),
    "CenterCoderTP": dict(templates_box=CODER_TEMPLATE),
    "CenterCoderMTTP": dict(tmp_box=[CODER_TEMPLATE]),
}
CODER_TIE = 1e-6        # kept scores closer than this may swap places
CODER_LOSS_TOL = 1e-4   # set losses, card against CPU, relative


def with_coder(m, tc, kind, kw):
    """The flagship's (model cfg, test cfg) with ``CODER_CONFIG`` naming
    ``kind`` and ``kw``, and the test cfg's rectify paired with it."""
    import copy

    m = copy.deepcopy(m)
    bh = m["bbox_head"]
    bh["CODER_CONFIG"] = dict(bh["CODER_CONFIG"], type=kind, **kw)
    return m, dict(tc, rectify=bool(kw.get("rectify")))


def kept_indices(det, maps):
    """Sample 0's kept candidates of ``det.decode(maps)``, recomputed by
    its steps (flatten, the coder's decode, the score and range mask,
    ``rotate_nms_pcdet``) on the maps' device -> (candidate indices,
    their scores), numpy, in kept order."""
    from partner_tpu_torch.models import e2e_head
    from partner_tpu_torch.ops.nms import rotate_nms_pcdet

    tc = det.test_cfg
    flat = e2e_head.flatten_head_preds(
        maps, det.module.bbox_head.offset_grid_on(maps["hm"].device))
    boxes, scores = e2e_head.decode_flat_preds(
        flat, det.coder, iou_factor=tc.get("iou_factor", 1.0),
        rectify=tc.get("rectify", False))
    score = scores[0].max(-1)[0]
    lim = tc.get("post_center_limit_range", [-80, -80, -10, 80, 80, 10])
    m = score > tc.get("score_threshold", 0.1)
    for i in range(3):
        m &= (boxes[0][:, i] >= lim[i]) & (boxes[0][:, i] <= lim[3 + i])
    masked = torch.where(m, score, torch.full_like(score, -float("inf")))
    nms = tc.get("nms", {})
    keep, kmask = rotate_nms_pcdet(
        boxes[0], masked, nms.get("nms_iou_threshold", 0.7),
        nms.get("nms_pre_max_size", 4096), nms.get("nms_post_max_size", 500))
    keep = keep[kmask & (masked[keep] > -float("inf"))]
    return keep.cpu().numpy(), score[keep].cpu().numpy()


def same_kept(kind, card, cpu):
    """Kept candidate indices of the card and of the CPU: equal, or each
    place where they differ a tie of the two scores there within
    CODER_TIE (named in the log) -> the number of such ties."""
    (ki, ks), (ci, cs) = card, cpu
    if len(ki) != len(ci):
        raise AssertionError(f"coder {kind}: kept {len(ki)} on the card, "
                             f"{len(ci)} on the CPU")
    ties = np.flatnonzero(ki != ci)
    for i in ties:
        log(f"coder {kind}: kept place {i}: card candidate {ki[i]} score "
            f"{ks[i]!r}, CPU candidate {ci[i]} score {cs[i]!r}")
        if not abs(ks[i] - cs[i]) <= CODER_TIE:
            raise AssertionError(f"coder {kind}: kept place {i} differs "
                                 "beyond a score tie")
    return len(ties)


def coder_train_reading(m, tc, dev, card, gen):
    """One batch-4 ``make_train_step`` step of the flagship under
    ``CenterCoderPolar(rectify=True)``: launches, finite loss terms, and
    the step's own set losses against the CPU criterion on the same head
    maps (copied to the CPU in float32) and the same assignment."""
    from partner_tpu_torch.losses import set_crit
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    _, _, batch, lr_max = train_cfgs()
    m, tc = with_coder(m, tc, "CenterCoderPolar", dict(rectify=True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    ex = to_device(train_example(
        np.random.RandomState(SEED + 24), m["bbox_head"]["voxel_generator"][
            "range"], det.module.grid_size, batch, TRAIN_POINTS, TRAIN_ROWS,
        MAX_BOXES), dev)
    step = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max=lr_max, total_steps=1000))
    seen = {}
    assign, set_losses = set_crit.assign_auction, det.set_losses

    def recorded(*args, **kwargs):
        seen["assigned"] = assign(*args, **kwargs)
        return seen["assigned"]

    def kept_maps(preds, example):
        seen["maps"] = {k: v.detach() for k, v in preds.items()}
        return set_losses(preds, example)

    set_crit.assign_auction, det.set_losses = recorded, kept_maps
    try:
        ms, met, counts = counted(lambda: step(
            ex, torch.Generator().manual_seed(SEED + 24)))
    finally:
        set_crit.assign_auction = assign
        del det.set_losses
    want = {"stem": 0, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    if counts != want:
        raise AssertionError(f"coder train step: launches {counts}")
    card_terms = {k: float(v) for k, v in met.items()}
    if not all(np.isfinite(list(card_terms.values()))):
        raise AssertionError(f"coder train step: {card_terms}")
    cpu_assigned = seen["assigned"].cpu()
    set_crit.assign_auction = lambda *a, **k: cpu_assigned
    try:
        with torch.no_grad():
            cpu = det.set_losses(
                {k: v.float().cpu() for k, v in seen["maps"].items()},
                {k: v.cpu() for k, v in ex.items()})
    finally:
        set_crit.assign_auction = assign
    rel = {k: abs(card_terms[k] - float(v)) / abs(float(v))
           for k, v in cpu.items() if k.startswith("loss")}
    log(f"coder train step (CenterCoderPolar, rectify) at batch {batch} on "
        f"{card}: {ms!r} ms, num_matched {card_terms['num_matched']!r}, "
        "loss terms " + ", ".join(f"{k} {card_terms[k]!r}" for k in rel)
        + "; relative error against the CPU criterion on the same maps "
        f"and assignment {rel} (bound {CODER_LOSS_TOL})")
    bad = {k: e for k, e in rel.items() if not e <= CODER_LOSS_TOL}
    if bad or not card_terms["num_matched"] > 0:
        raise AssertionError(f"coder train step: {bad}, num_matched "
                             f"{card_terms['num_matched']}")
    return dict(ms=ms, launches=counts, rel=rel,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


@torch.no_grad()
def coder_phase(dev, card):
    """The flagship at full width (seeded weights, the 180,000-point sweep
    in 216,000 rows, batch 1) under each of the six variant coders of
    ``CODER_CONFIG["type"]`` (CODER_VARIANTS): one ``predict`` with its
    stem, scatter-max and attention launches; then the card's decode +
    NMS of the frame's head maps against the CPU's in float32 on the same
    maps (kept candidates equal, or a named score tie); and one batch-4
    train step under the polar rectified coder
    (:func:`coder_train_reading`)."""
    from partner_tpu_torch.models import build_detector

    t_phase = time.perf_counter()
    base_m, base_tc = frame_cfgs()
    gen = torch.Generator().manual_seed(SEED + 24)
    base = build_detector(base_m, None, base_tc, device=dev, generator=gen)
    randomize_norms(base.module, gen)
    state = base.module.state_dict()
    del base
    pts, mask = synthetic_sweep(
        np.random.RandomState(SEED + 24),
        base_m["bbox_head"]["voxel_generator"]["range"], N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)
    res = {}
    for kind, kw in CODER_VARIANTS.items():
        m, tc = with_coder(base_m, base_tc, kind, kw)
        det = build_detector(m, None, tc, device=dev)
        det.module.load_state_dict(state)
        if type(det.coder).__name__ != kind:
            raise AssertionError(f"built {type(det.coder).__name__}")
        det.predict(ex)   # warm-up: the first call of a new coder
        ms, out, counts = counted(lambda: det.predict(ex))
        depth = det.module.bbox_head.layer.depth
        if counts != {"stem": 1, "scatter_max": 1, "swin_attn": depth,
                      "swin_block": 0}:
            raise AssertionError(f"coder {kind}: launches {counts}")
        n_kept = check_detections(out, tc)
        maps = det.module(ex)
        nms_ms, _, _ = counted(lambda: det.decode(maps))
        cpu_maps = {k: v.float().cpu() for k, v in maps.items()}
        t0 = time.perf_counter()
        det.decode(cpu_maps)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        ties = same_kept(kind, kept_indices(det, maps),
                         kept_indices(det, cpu_maps))
        log(f"coder {kind} {kw}: predict {ms!r} ms on {card}, launches "
            f"{counts}, {n_kept} kept; decode + NMS of its maps "
            f"{nms_ms!r} ms on the card, {cpu_ms!r} ms on the CPU, kept "
            f"candidates equal but {ties} score ties")
        res[kind] = dict(ms=ms, launches=counts, kept=n_kept,
                         nms_ms=nms_ms, cpu_nms_ms=cpu_ms, ties=ties)
        del det, maps, cpu_maps
    with torch.enable_grad():
        res["train"] = coder_train_reading(base_m, base_tc, dev, card, gen)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"coder phase: {res['phase_s']!r} s")
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
    nusc = nusc_phase(dev, card)
    pp = pp_phase(dev, card)
    polar = polarstream_phase(dev, card)
    seg = seg_phase(dev, card)
    han = strobe_han_phase(dev, card)
    dp = dist_phase(dev, card)
    mp = mesh_phase(dev, card)
    tools = tools_phase(dev, card)
    coders = coder_phase(dev, card)

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
    sh, pts = nusc["singlehead"], pp["two_stage"]
    # each path's launches of each kernel, as its phase asserted them
    want_sh = {"stem": NUSC_TIMED, "scatter_max": NUSC_TIMED}
    for key, tally, want in (
            ("singlehead frame", sh["frame"]["launches"], want_sh),
            ("singlehead dist_test", sh["dist_test"]["launches"],
             {"stem": NUSC_FRAMES, "scatter_max": NUSC_FRAMES}),
            ("singlehead train", sh["train"]["launches"],
             {"scatter_max": TRAIN_STEPS + 1}),
            ("singlehead train CLI", sh["train_cli"]["launches"],
             {"scatter_max": 2})) + tuple(
            (f"pp two-stage {k}", pts[k]["launches"], {})
            for k in ("frame", "two_class", "train", "train_cli",
                      "dist_test")) + tuple(
            (f"polarstream {c} {k}", polar[c][k]["launches"] if k != "frame"
             else polar[c]["launches"], {})
            for c in POLAR_CONFIGS
            for k in ("frame", "train", "dist_test", "train_cli")) + tuple(
            (f"seg {c} {k}", seg[c][k]["launches"] if k != "frame"
             else seg[c]["launches"], {})
            for c in SEG_CONFIGS
            for k in ("frame", "train", "dist_test", "train_cli")) + tuple(
            (f"{c} {k}", (han[c]["launches"] if k == "frame"
                          else han[c][k]["launches"]), {})
            for c in STROBE_HAN_CONFIGS for k in SH_PATHS[c[:-2]]):
        if tally != {k: want.get(k, 0) for k in meta}:
            raise AssertionError(f"{key} launches {tally}")
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
                    **{f"nusc_{c}_frame_launches": nusc[c]["launches"][name]
                       for c in NUSC_CONFIGS},
                    nusc_train_launches=nusc["train"]["launches"][name],
                    nusc_dist_test_launches=nusc["dist_test"]["launches"][
                        name],
                    nusc_train_cli_launches=nusc["train_cli"]["launches"][
                        name],
                    pp_frame_launches=pp["three_class"]["launches"][name],
                    pp_two_class_frame_launches=pp["two_class"]["launches"][
                        name],
                    pp_train_launches=pp["train"]["launches"][name],
                    pp_dist_test_launches=pp["dist_test"]["launches"][name],
                    pp_train_cli_launches=pp["train_cli"]["launches"][name],
                    singlehead_frame_launches=sh["frame"]["launches"][name],
                    singlehead_train_launches=sh["train"]["launches"][name],
                    singlehead_dist_test_launches=sh["dist_test"][
                        "launches"][name],
                    singlehead_train_cli_launches=sh["train_cli"][
                        "launches"][name],
                    pp_two_stage_frame_launches=pts["frame"]["launches"][
                        name],
                    pp_two_stage_two_class_frame_launches=pts["two_class"][
                        "launches"][name],
                    pp_two_stage_frozen_train_launches=pts["train"][
                        "launches"][name],
                    pp_two_stage_train_cli_launches=pts["train_cli"][
                        "launches"][name],
                    pp_two_stage_dist_test_launches=pts["dist_test"][
                        "launches"][name],
                    **{f"polarstream_{c}_{k}_launches": (
                        polar[c]["launches"] if k == "frame"
                        else polar[c][k]["launches"])[name]
                       for c in POLAR_CONFIGS
                       for k in ("frame", "train", "dist_test",
                                 "train_cli")},
                    **{f"seg_{c}_{k}_launches": (
                        seg[c]["launches"] if k == "frame"
                        else seg[c][k]["launches"])[name]
                       for c in SEG_CONFIGS
                       for k in ("frame", "train", "dist_test",
                                 "train_cli")},
                    **{f"{c}_{k}_launches": (
                        han[c]["launches"] if k == "frame"
                        else han[c][k]["launches"])[name]
                       for c in STROBE_HAN_CONFIGS
                       for k in SH_PATHS[c[:-2]]},
                    dist_ddp_step_launches=dp["step"]["launches"][name],
                    dist_dist_test_launches=dp["dist_test"]["launches"][name],
                    dist_train_cli_launches=dp["train_cli"]["launches"][name],
                    **{f"mesh_{spec.replace('=', '')}_{path}_launches": [
                        r[name] for r in mp[spec][path]["launches"]]
                       for spec in MESH_SPECS
                       for path in ("dist_test", "block", "train", "cp")
                       if path in mp[spec]},
                    tools_dist_test_launches=tools["dist_test"]["launches"][
                        name],
                    tools_flops_report_launches=tools["flops"]["launches"][
                        name],
                    coder_launches={k: coders[k]["launches"][name]
                                    for k in CODER_VARIANTS},
                    coder_train_launches=coders["train"]["launches"][name],
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
    st, sm, dc = kres["stem"], kres["scatter_max"], nusc["deform_conv"]
    log(f"summary: card {card}, nuScenes CenterPoint frame median ms "
        + ", ".join(f"{c} {nusc[c]['median_ms']!r} (device busy "
                    f"{nusc[c]['device_busy_ms']!r}, "
                    f"{nusc[c]['launches_per_frame']!r} launches)"
                    for c in NUSC_CONFIGS)
        + f"; deformable conv {dc['ms']!r} ms a call ({dc['device_ms']!r} "
        f"device, bound {dc['bound_ms']!r}) at {dc['shape']}, 12 a frame; "
        f"dist_test (dcn) middle-third FPS {nusc['dist_test']['fps']!r}; "
        f"train step at batch 4 {nusc['train']['median_ms']!r} ms, peak "
        f"{nusc['train']['peak_gib']!r} GiB; train CLI 2 steps in "
        f"{nusc['train_cli']['wall_s']!r} s; stem C_in 8 device "
        f"{st['device_ms_nusc_b1']!r} / {st['device_ms_nusc_b4']!r} ms at "
        f"batch 1 / 4 (bound {st['bound_ms_nusc_b1']!r} / "
        f"{st['bound_ms_nusc_b4']!r}), C_in 10 "
        f"{st['device_ms_nusc_c10_b1']!r} ms (bound "
        f"{st['bound_ms_nusc_c10_b1']!r}); scatter-max device "
        + ", ".join(f"{c} {sm['device_ms_nusc_' + c]!r} (bound "
                    f"{sm['bound_ms_nusc_' + c]!r}, "
                    f"{sm['not_equal_nusc_' + c]} not equal)"
                    for c in list(NUSC_CONFIGS) + ["dcn_train_f32"]))
    pt = pp["three_class"]
    log(f"summary: card {card}, PointPillars frame median "
        + ", ".join(f"{c} {pp[c]['median_ms']!r} ms (device busy "
                    f"{pp[c]['device_busy_ms']!r}, "
                    f"{pp[c]['launches_per_frame']!r} launches)"
                    for c in PP_CONFIGS)
        + f"; pillars {pt['occupied']} occupied, {pt['pillars']} kept of "
        f"{pt['capacity']}, {pt['dropped_points']} points dropped; train "
        f"step at batch "
        f"4 {pp['train']['median_ms']!r} ms, peak {pp['train']['peak_gib']!r}"
        f" GiB; dist_test middle-third FPS {pp['dist_test']['fps']!r}; "
        f"train CLI 2 steps in {pp['train_cli']['wall_s']!r} s")
    sf, nr = sh["frame"], sh["frame"]["nms"]
    log(f"summary: card {card}, nuScenes single-head frame median "
        f"{sf['median_ms']!r} ms (device busy {sf['device_busy_ms']!r}, "
        f"{sf['launches_per_frame']!r} launches), decode + per-class NMS "
        f"{nr['ms']!r} ms over {nr['candidates']} candidates in "
        f"{nr['sweeps']} fixpoint sweeps, suppression matrix "
        f"{nr['iou_device_ms']!r} ms device; train step at batch 4 "
        f"{sh['train']['median_ms']!r} ms, peak {sh['train']['peak_gib']!r} "
        f"GiB; dist_test middle-third FPS {sh['dist_test']['fps']!r}; train "
        f"CLI 2 steps in {sh['train_cli']['wall_s']!r} s")
    tf = pts["frame"]
    log(f"summary: card {card}, PointPillars two-stage frame median "
        f"{tf['median_ms']!r} ms against the one-stage "
        f"{tf['one_stage_median_ms']!r} taking turns (device busy "
        f"{tf['device_busy_ms']!r}, {tf['launches_per_frame']!r} launches), "
        f"refine {tf['refine_ms']!r} ms device in "
        f"{tf['refine_launches']!r} launches; 2-class frame "
        f"{pts['two_class']['median_ms']!r} ms; frozen step at batch 4 "
        f"{pts['train']['median_ms']!r} ms, peak "
        f"{pts['train']['peak_gib']!r} GiB; train CLI 2 steps in "
        f"{pts['train_cli']['wall_s']!r} s; dist_test middle-third FPS "
        f"{pts['dist_test']['fps']!r}")
    log(f"summary: card {card}, PolarStream " + "; ".join(
        f"{c}: frame median {polar[c]['median_ms']!r} ms (device busy "
        f"{polar[c]['device_busy_ms']!r}, {polar[c]['launches_per_frame']!r}"
        f" launches), decode + stateful NMS {polar[c]['nms']['ms']!r} ms, "
        f"{polar[c]['nms']['sweeps_per_sector']!r} fixpoint sweeps a sector, "
        f"{polar[c]['kept']} boxes kept, points lost to the caps "
        f"{polar[c]['census']['lost_share']!r}; train step at batch 4 "
        f"{polar[c]['train']['median_ms']!r} ms, peak "
        f"{polar[c]['train']['peak_gib']!r} GiB; dist_test middle-third FPS "
        f"{polar[c]['dist_test']['fps']!r} (with one loader thread "
        f"{polar[c]['dist_test']['bit_equal']} of "
        f"{polar[c]['dist_test']['frames']} frames bit-equal to predict);"
        f" train CLI 2 steps in {polar[c]['train_cli']['wall_s']!r} s"
        for c in POLAR_CONFIGS))
    log(f"summary: card {card}, segmentation " + "; ".join(
        f"{c}: frame median {seg[c]['median_ms']!r} ms (device busy "
        f"{seg[c]['device_busy_ms']!r}, {seg[c]['launches_per_frame']!r} "
        f"launches), {seg[c]['labelled']!r} of the points labelled; card "
        f"against CPU {seg[c]['reference'][1]} near-tie labels of "
        f"{seg[c]['reference'][0]}; train step at batch 4 "
        f"{seg[c]['train']['median_ms']!r} ms, peak "
        f"{seg[c]['train']['peak_gib']!r} GiB; dist_test middle-third FPS "
        f"{seg[c]['dist_test']['fps']!r}, mIoU "
        f"{seg[c]['dist_test']['miou']!r}, PQ {seg[c]['dist_test']['pq']!r};"
        f" train CLI 2 steps in {seg[c]['train_cli']['wall_s']!r} s"
        for c in SEG_CONFIGS))
    w = han["warp"]
    log(f"summary: card {card}, HAN and STROBE " + "; ".join(
        f"{c}: frame median {han[c]['median_ms']!r} ms (device busy "
        f"{han[c]['device_busy_ms']!r}, {han[c]['launches_per_frame']!r} "
        f"launches), decode + NMS {han[c]['nms']['ms']!r} ms, "
        f"{han[c]['kept']} boxes kept; train step at batch 4 "
        f"{han[c]['train']['median_ms']!r} ms on "
        f"{han[c]['train']['points']} points, peak "
        f"{han[c]['train']['peak_gib']!r} GiB"
        + (f"; dist_test middle-third FPS {han[c]['dist_test']['fps']!r}, "
           f"mIoU {han[c]['dist_test']['miou']!r}; train CLI 1 step in "
           f"{han[c]['train_cli']['wall_s']!r} s" if "dist_test" in han[c]
           else "") for c in STROBE_HAN_CONFIGS)
        + f"; ego_motion_warp_polar {WARP_SHAPE} {w['device_ms']!r} ms "
        f"device (bound {w['bound_ms']!r}), relative RMS against the CPU "
        f"{w['rel_rms']!r}")
    st = dp["step"]
    log(f"summary: card {card}, data parallelism (NCCL, world 1): flagship "
        f"float32 step at batch 4 plain {st['plain_ms']!r} ms, DDP "
        f"{st['ddp_ms']!r} ms, {st['collectives']} collectives a step, "
        f"parameters where Adam's step is determined within "
        f"{st['firm_err']!r} beyond 1e-6 relative, {st['loose_share']!r} of "
        f"the elements undetermined, bit-equal {st['bit_equal']}; dist_test "
        f"under torchrun middle-third "
        f"FPS {dp['dist_test']['fps']!r} (without a group "
        f"{dp['dist_test']['plain_fps']!r}); train CLI under torchrun 2 "
        f"steps in {dp['train_cli']['wall_s']!r} s; lr family card against "
        f"CPU {({k: v[0] for k, v in dp['family'].items()})}; phase "
        f"{dp['phase_s']!r} s")
    log(f"summary: card {card}, mesh (two processes on the one card over "
        f"gloo; smoke readings): " + "; ".join(
            f"{spec}: dist_test {mp[spec]['dist_test']['ms_frame']!r} ms a "
            f"frame per rank, kept rows (at place, near-ties, all) "
            f"{mp[spec]['kept']}, float32 step at batch {MESH_BATCH} "
            f"{mp[spec]['train']['ms']!r} then "
            f"{mp[spec]['train']['second_ms']!r} ms per rank (one process "
            f"{mp[spec]['train']['one_ms']!r}), "
            f"{mp[spec]['train']['collectives']} collectives a step, "
            f"parameters where Adam's step is determined (on "
            f"{mp[spec]['train']['firm_share']!r} of them) within "
            f"{mp[spec]['train']['firm_err']!r}, bit-equal "
            f"{mp[spec]['train']['bit_equal']}, peak "
            f"{mp[spec]['peak_gib']!r} GiB per rank" for spec in MESH_SPECS)
        + f"; phase {mp['phase_s']!r} s")
    ta, cs, fl = tools["dist_test"], tools["cswin"], tools["flops"]
    log(f"summary: card {card}, tools (no JAX): dist_test over "
        f"{TOOLS_FRAMES} fake frames then track, {ta['tracked']} tracked "
        f"boxes in {ta['ids']} tracks, {ta['track_ms']!r} ms a frame; ground "
        f"truth MOTA {tools['mota']['mota']!r} with "
        f"{tools['mota']['id_switches']} id switches; nms_ensemble "
        f"{tools['ensemble']['ms']!r} ms a frame on the card (CPU "
        f"{tools['ensemble']['cpu_ms']!r}), kept boxes equal; CSWinBlock "
        f"{CSWIN_SHAPE} rows and columns {cs['rows_cols']['ms']!r} ms, peak "
        f"{cs['rows_cols']['peak_gib']!r} GiB, last stage "
        f"{cs['last_stage']['ms']!r} ms, peak {cs['last_stage']['peak_gib']!r}"
        f" GiB, relative RMS against the CPU {cs['rows_cols']['rel_rms']!r} / "
        f"{cs['last_stage']['rel_rms']!r}; flagship {fl['gflop']!r} GFLOP a "
        f"frame on both routes, frame median {fl['median_ms']!r} ms, MFU "
        f"{fl['mfu']!r} of {fl['peak']!r} FLOP/s bf16; phase "
        f"{tools['phase_s']!r} s")
    log(f"summary: card {card}, box coders (flagship frame, full width): "
        + "; ".join(f"{k}: predict {coders[k]['ms']!r} ms, {coders[k]['kept']}"
                    f" kept, decode + NMS {coders[k]['nms_ms']!r} ms (CPU "
                    f"{coders[k]['cpu_nms_ms']!r}), {coders[k]['ties']} ties"
                    for k in CODER_VARIANTS)
        + f"; polar rectified train step at batch 4 "
        f"{coders['train']['ms']!r} ms, peak {coders['train']['peak_gib']!r}"
        f" GiB, set losses against the CPU {coders['train']['rel']}; phase "
        f"{coders['phase_s']!r} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
