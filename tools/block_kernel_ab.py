#!/usr/bin/env python3
"""Time the whole-block SwinVote kernel of one source tree on one CUDA card.

    python3 tools/block_kernel_ab.py [--tree DIR] [--time-only]

Imports ``partner_tpu_torch`` from ``--tree`` (default: this repository)
and builds that tree's kernels; the inputs, the check and the timing are
this repository's ``chip_smoke.py``. At the flagship shape (x (1, 256,
144, 256) bf16, 576 windows; ``chip_smoke.block_case``), for the shifted
and the unshifted block, it holds the kernel against the tree's plain
twin within ``chip_smoke.KERNEL_TOL``, then times one call (``ms``:
``chip_smoke.cuda_ms``, the median of single calls, the wrapper's host
time included where it is the longer) and one launch on the device
(``device_ms``: ``chip_smoke.device_ms``, back-to-back launches, warm
L2). ``--time-only`` skips the
check, for a tree whose kernel was cut on purpose
(``tools/block_kernel_parts.py``). Prints the ptxas report of
``swin_block_kernel`` and, as its last line, one JSON object.

To compare two commits on one card, unpack the other into a directory
and run both trees in turns in one session (A, B, B, A): times move
between machines and calls.
"""

import argparse
import json
import os
import sys


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=here)
    ap.add_argument("--time-only", action="store_true",
                    help="time the kernel without holding it to its twin")
    args = ap.parse_args()
    sys.path.insert(0, here)
    import chip_smoke
    import torch

    # partner_tpu_torch comes from the tree: chip_smoke imports it lazily
    sys.path.insert(0, os.path.abspath(args.tree))
    from partner_tpu_torch.ops import _cuda, swin_block

    if not torch.cuda.is_available():
        sys.exit("block_kernel_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _cuda.library()
    lines = lib.ptxas_log.splitlines()
    start = max((i for i, ln in enumerate(lines)
                 if "Compiling entry" in ln and "swin_block_kernel" in ln),
                default=len(lines))
    ptxas = [ln.strip() for ln in lines[start:start + 4]
             if "registers" in ln or "spill" in ln or "smem" in ln]
    for ln in ptxas:
        print("ptxas swin_block_kernel:", ln, flush=True)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    res = {"tree": os.path.abspath(args.tree),
           "card": chip_smoke.gpu_name_and_power_limit(), "ptxas": ptxas}
    for shift in (4, 0):
        kargs, _ = chip_smoke.block_case(gen, dev, shift)
        tag = "shifted" if shift else "unshifted"
        if not args.time_only:
            out = swin_block.swin_vote_block(*kargs)
            ref = swin_block.swin_vote_block_plain(*kargs)
            torch.cuda.synchronize()
            res[f"max_abs_err_{tag}"] = chip_smoke.compare(
                f"swin_vote_block {tag}", out, ref, chip_smoke.KERNEL_TOL)
        kernel = lambda: swin_block.swin_vote_block(*kargs)
        res[f"device_ms_{tag}"] = chip_smoke.device_ms(kernel)
        res[f"ms_{tag}"] = chip_smoke.cuda_ms(kernel)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
