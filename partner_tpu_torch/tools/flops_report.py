"""Per-module FLOP table of a config's ``predict`` (counterpart of
``tools/flops_report.py``).

    python -m partner_tpu_torch.tools.flops_report
        [--config configs/waymo/waymo_partner_36epoch.py] [--depth 3]
        [--points 180000] [--device cuda|cpu]

Builds the detector on ``--device`` (the card unless ``--device cpu``;
with no card it stops with an error rather than run on the CPU) with
seeded random weights, runs one ``predict`` of the JAX tool's synthetic
sweep (``np.random.RandomState(0)``: ``--points`` points log-uniform in
range over the config's point range, in a buffer 1.2 x as long) under
``utils.flops.per_module_flops`` and prints {module: GFLOP, share} and
the total. On the card the hand kernels charge their FLOPs to the count
(``utils/flops.py``), so the table is the plain twins' too.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synthetic_sweep(pc_range, n, c):
    """The JAX tool's seeded sweep -> (points (1.2 n, c) float32, mask)."""
    rng = np.random.RandomState(0)
    rho = np.exp(rng.uniform(np.log(pc_range[0] + 0.2),
                             np.log(pc_range[3] - 0.2), n))
    z = np.clip(pc_range[2] + np.abs(rng.randn(n)) * 0.18
                * (pc_range[5] - pc_range[2]), pc_range[2], pc_range[5])
    phi = rng.uniform(pc_range[1], pc_range[4], n)
    cols = [rho, phi, z, rho * np.cos(phi), rho * np.sin(phi)]
    while len(cols) < c:
        cols.append(rng.rand(n))
    pts = np.stack(cols[:c], 1).astype(np.float32)
    pad = np.zeros((int(n * 1.2), c), np.float32)
    pad[:n] = pts
    mask = np.zeros((len(pad),), bool)
    mask[:n] = True
    return pad, mask


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config",
                   default="configs/waymo/waymo_partner_36epoch.py")
    p.add_argument("--depth", type=int, default=3,
                   help="module-path components to group by")
    p.add_argument("--points", type=int, default=180000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def build_frame(config, n_points, device):
    """(the config's detector on ``device``, seeded weights; its
    :func:`synthetic_sweep` example on ``device``)."""
    import torch

    from ..models import build_detector
    from ..utils.config import load_config

    cfg = load_config(os.path.join(ROOT, config))
    det = build_detector(cfg["model"], cfg.get("train_cfg"),
                         cfg.get("test_cfg"), device=device,
                         generator=torch.Generator().manual_seed(0))
    c = cfg["model"].get("reader", {}).get("num_input_features", 7)
    pts, mask = synthetic_sweep(cfg["voxel_generator"]["range"], n_points,
                                c)
    example = {"points": torch.from_numpy(pts)[None].to(device),
               "points_mask": torch.from_numpy(mask)[None].to(device)}
    return det, example


def main(argv=None):
    """-> ({module path: FLOPs}, total FLOPs)."""
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("flops_report: no CUDA device; pass --device cpu to run on "
                 "the CPU")
    from ..utils.flops import per_module_flops

    det, example = build_frame(args.config, args.points,
                               torch.device(args.device))
    with torch.no_grad():
        tbl = per_module_flops(det.predict, example, depth=args.depth)

    total = sum(tbl.values())
    width = max(len(k) for k in tbl)
    print(f"{'module':<{width}}  {'GFLOP':>10}  {'%':>6}")
    for k, v in tbl.items():
        print(f"{k:<{width}}  {v / 1e9:10.2f}  {100 * v / total:6.2f}")
    print(f"{'TOTAL':<{width}}  {total / 1e9:10.2f}")
    return tbl, total


if __name__ == "__main__":
    main()
