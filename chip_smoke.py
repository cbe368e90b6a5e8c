#!/usr/bin/env python3
"""Smoke run of partner_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA; it uses card 0. Phases:

1. environment: the card's ``nvidia-smi`` name and power limit, the torch
   and CUDA versions, and the ``nvcc`` build of the kernels in
   ``partner_tpu_torch/csrc`` (time, registers, shared memory);
2. kernels: each hand-written kernel against its plain PyTorch twin on the
   same bf16 inputs at the flagship frame's shapes, with the error bound
   stated below, and the median time of each beside its twin's;
3. frame: the flagship PARTNER detector
   (``configs/waymo/waymo_partner_36epoch.py``) at full width in bf16,
   random weights from a seeded ``torch.Generator`` with every norm
   parameter and statistic randomized, driven through
   ``E2EDetector.predict`` on a synthetic 180,000-point sweep in a
   216,000-row buffer; the kernels' launch counts over those frames, the
   median frame time, finite outputs, and NMS that kept boxes;
4. reference: the flagship widths on a small grid, the card's frame (bf16,
   CUDA kernels) against the CPU's (float32, plain twins) with the same
   weights and points.

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
FRAMES = 5                   # timed frames after one warm-up frame
SMALL_GRID = (256, 512, 40)  # reference phase: BEV 64 (az) x 32 (r)

# Kernel vs plain twin, both bf16 on the card: |kernel - plain| <=
# KERNEL_TOL * (1 + |plain|), two bf16 ulps. Both accumulate in f32 but in
# another order, which can flip the bf16 rounding of a stem hidden value or
# an attention probability.
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


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power_limit():
    res = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip()


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of one call of ``fn`` on the card, CUDA events."""
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
    from partner_tpu_torch.utils.config import load_config

    bh = load_config(CONFIG)["model"]["bbox_head"]
    vg = bh["voxel_generator"]
    grid = tuple(int(round((vg["range"][3 + i] - vg["range"][i])
                           / vg["voxel_size"][i])) for i in range(3))
    ws = bh["HEAD_CONFIG"]["window_size"]
    og = e2e_head.head_offset_grid(grid, vg["range"], 8)    # (256, 144, 2)
    pos = swin_vote.window_partition(torch.from_numpy(og)[None], ws)
    nw, nh, hd = pos.shape[0], 4, bh["in_channels"] // 2 // 4
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


def kernel_phase(gen, dev):
    from partner_tpu_torch.ops import stem, swin_attn

    results = {}
    args = stem_case(gen, dev)
    out = stem.stem2_channel_major(*args)
    ref = stem.stem2_channel_major_plain(*args)
    torch.cuda.synchronize()
    err = compare("stem2_channel_major (1, 10, 216000)", out, ref, KERNEL_TOL)
    results["stem"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: stem.stem2_channel_major(*args)),
        plain_ms=cuda_ms(lambda: stem.stem2_channel_major_plain(*args)))

    errs, times = [], {}
    for with_mask in (True, False):
        args = attn_case(gen, dev, with_mask)
        out = swin_attn.swin_vote_attention(*args)
        ref = swin_attn.swin_vote_attention_plain(*args)
        torch.cuda.synchronize()
        tag = "mask" if with_mask else "no_mask"
        errs.append(compare(f"swin_vote_attention (576, 4, 64, 64) {tag}",
                            out, ref, KERNEL_TOL))
        times[tag] = (
            cuda_ms(lambda: swin_attn.swin_vote_attention(*args)),
            cuda_ms(lambda: swin_attn.swin_vote_attention_plain(*args)))
    results["swin_attn"] = dict(
        max_abs_err=max(errs), ms=times["mask"][0],
        plain_ms=times["mask"][1], ms_no_mask=times["no_mask"][0],
        plain_ms_no_mask=times["no_mask"][1])
    for name, r in results.items():
        log(f"{name}: kernel {r['ms']!r} ms, plain {r['plain_ms']!r} ms "
            "(median of 20 calls, CUDA events, warm L2)")
    log(f"swin_attn unshifted: kernel {results['swin_attn']['ms_no_mask']!r}"
        f" ms, plain {results['swin_attn']['plain_ms_no_mask']!r} ms")
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


def frame_phase(dev):
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops import stem, swin_attn

    m, tc = frame_cfgs()
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    det = build_detector(m, None, tc, device=dev, generator=gen)
    randomize_norms(det.module, gen)
    n_params = sum(p.numel() for p in det.module.parameters())
    log(f"flagship detector: grid {det.module.grid_size}, {n_params} params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    pts, mask = synthetic_sweep(np.random.RandomState(SEED),
                                m["bbox_head"]["voxel_generator"]["range"],
                                N_POINTS)
    ex = to_device({"points": pts, "points_mask": mask}, dev)

    stem.stem2_channel_major.launches = 0
    swin_attn.swin_vote_attention.launches = 0
    out = det.predict(ex)                                  # warm-up frame
    torch.cuda.synchronize()
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        out = det.predict(ex)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"stem": stem.stem2_channel_major.launches,
                "swin_attn": swin_attn.swin_vote_attention.launches}
    log(f"flagship frame: median {statistics.median(times)!r} ms over "
        f"{FRAMES} frames (host clock around a synchronized predict), "
        f"all {times!r}")
    log(f"kernel launches over {FRAMES + 1} frames: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched in the frame")

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
    return launches, statistics.median(times)


def rel_rms(name, got, want, bound):
    got = got.float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"reference {name}: shape or non-finite")
    err = (got - want).abs()
    r = float(err.norm() / want.norm())
    log(f"reference {name} {tuple(want.shape)}: relative RMS error {r!r} "
        f"(bound {bound}), max abs err {float(err.max())!r}")
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
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    gen = torch.Generator().manual_seed(SEED)
    kres = kernel_phase(gen, dev)
    launches, frame_ms = frame_phase(dev)
    reference_phase(dev)

    meta = {
        "stem": ("partner_tpu_torch/csrc/stem.cu",
                 "partner_tpu/ops/stem_pallas.py:79"),
        "swin_attn": ("partner_tpu_torch/csrc/swin_attn.cu",
                      "partner_tpu/ops/swin_attn_pallas.py:137"),
    }
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1], launches=launches[name], **r)
               for name, r in kres.items()]
    log(f"summary: card {card}, flagship frame median {frame_ms!r} ms")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
