#!/usr/bin/env python3
"""Check and time one hand-written kernel of one source tree on one CUDA
card.

    python3 tools/kernel_ab.py --kernel {stem,scatter_max,swin_attn,swin_block}
                               [--tree DIR] [--time-only]

Imports ``partner_tpu_torch`` from ``--tree`` (default: this repository)
and builds that tree's kernels; the inputs, the checks and the timing are
this repository's ``chip_smoke.py``, at the flagship shapes:

- ``stem``: x (1, 10, 216,000) bf16 (``chip_smoke.stem_case``), held
  against the tree's plain twin within ``chip_smoke.KERNEL_TOL``, with the
  count of outputs that differ from it;
- ``scatter_max``: the twin's stem output on those inputs scattered into
  the flagship canvas (``chip_smoke.scatter_case``), in bf16 and float32,
  held to the twin exactly; also the device time of the wrapper's zero fill
  alone (``torch.zeros`` of the canvas);
- ``swin_attn``: q, k, v (576, 4, 64, 64) bf16 with the real cell
  positions (``chip_smoke.attn_case``), with and without the
  shifted-window mask, within ``KERNEL_TOL`` of the twin; also the device
  time of ``F.scaled_dot_product_attention`` on the same q, k, v with the
  bias summed beforehand (``chip_smoke.attention_library_call``: the
  attention core only);
- ``swin_block``: x (1, 256, 144, 256) bf16 (``chip_smoke.block_case``),
  the shifted and the unshifted block, within ``KERNEL_TOL`` of the twin.

Each is timed per call (``ms``: ``chip_smoke.cuda_ms``, the median of
single calls, the wrapper's host time included where it is the longer) and
on the device (``device_ms``: ``chip_smoke.device_ms``, back-to-back
launches) beside its bound (``chip_smoke.bound``). Prints the ptxas report
of the kernel's entries (when this process built the library) and, as its
last line, one JSON object. ``--time-only`` skips the checks, for a tree
whose kernel was cut on purpose (``tools/attn_kernel_parts.py``,
``tools/block_kernel_parts.py``).

To compare two commits on one card, unpack the other into a directory and
run both trees in turns in one run (A, B, B, A): times move between
machines and calls.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

# substring of the mangled names of each kernel's entries in the ptxas log
ENTRIES = {"stem": "stem2", "scatter_max": "scatter_max",
           "swin_attn": "swin_attn_kernel", "swin_block": "swin_block_kernel"}


def ptxas_lines(log, key):
    lines, entry = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            entry = key in ln
        if entry and ("Compiling entry" in ln or "registers" in ln
                      or "spill" in ln):
            lines.append(ln.strip())
    return lines


def time_stem(chip_smoke, gen, dev, check):
    from partner_tpu_torch.ops import stem

    args = chip_smoke.stem_case(gen, dev)
    res = {}
    if check:
        out = stem.stem2_channel_major(*args)
        ref = stem.stem2_channel_major_plain(*args)
        torch.cuda.synchronize()
        res["max_abs_err"] = chip_smoke.compare(
            "stem", out, ref, chip_smoke.KERNEL_TOL)
        res.update(chip_smoke.not_equal("stem", out, ref))
    res.update(chip_smoke.call_and_device_ms(
        "ms", lambda: stem.stem2_channel_major(*args)))
    res["bound_ms"] = chip_smoke.bound(
        chip_smoke.kernel_work("stem", *args))[0]
    return res


def time_scatter(chip_smoke, gen, dev, check):
    from partner_tpu_torch.ops import scatter_max, stem

    sargs = chip_smoke.scatter_case(stem.stem2_channel_major_plain(
        *chip_smoke.stem_case(gen, dev)), dev)
    b, c, _ = sargs[0].shape
    cells = b * int(np.prod(sargs[3]))
    res = {}
    for tag, dt in (("", torch.bfloat16), ("_f32", torch.float32)):
        args = (sargs[0].to(dt),) + tuple(sargs[1:])
        if check:
            out = scatter_max.scatter_max_fold2d(*args)
            ref = scatter_max.scatter_max_fold2d_plain(*args)
            torch.cuda.synchronize()
            res[f"max_abs_err{tag}"] = chip_smoke.compare(
                f"scatter_max{tag}", out, ref, 0.0)
        res.update(chip_smoke.call_and_device_ms(
            f"ms{tag}", lambda: scatter_max.scatter_max_fold2d(*args)))
        res[f"zero_device_ms{tag}"] = chip_smoke.device_ms(
            lambda: torch.zeros((cells, c), dtype=dt, device=dev))
        res[f"bound_ms{tag}"] = chip_smoke.bound(
            chip_smoke.kernel_work("scatter_max", *args))[0]
    return res


def time_attn(chip_smoke, gen, dev, check):
    from partner_tpu_torch.ops import swin_attn

    res = {}
    for with_mask in (True, False):
        kargs = chip_smoke.attn_case(gen, dev, with_mask)
        tag = "mask" if with_mask else "no_mask"
        if check:
            out = swin_attn.swin_vote_attention(*kargs)
            ref = swin_attn.swin_vote_attention_plain(*kargs)
            torch.cuda.synchronize()
            res[f"max_abs_err_{tag}"] = chip_smoke.compare(
                f"swin_vote_attention {tag}", out, ref, chip_smoke.KERNEL_TOL)
        kernel = lambda: swin_attn.swin_vote_attention(*kargs)
        res[f"device_ms_{tag}"] = chip_smoke.device_ms(kernel)
        res[f"ms_{tag}"] = chip_smoke.cuda_ms(kernel)
        res[f"library_device_ms_{tag}"] = chip_smoke.device_ms(
            chip_smoke.attention_library_call(kargs))
        res[f"bound_ms_{tag}"] = chip_smoke.bound(
            chip_smoke.kernel_work("swin_attn", *kargs))[0]
        res[f"bound_share_{tag}"] = (res[f"bound_ms_{tag}"]
                                     / res[f"device_ms_{tag}"])
    return res


def time_block(chip_smoke, gen, dev, check):
    from partner_tpu_torch.ops import swin_block

    res = {}
    for shift in (4, 0):
        kargs, _ = chip_smoke.block_case(gen, dev, shift)
        tag = "shifted" if shift else "unshifted"
        if check:
            out = swin_block.swin_vote_block(*kargs)
            ref = swin_block.swin_vote_block_plain(*kargs)
            torch.cuda.synchronize()
            res[f"max_abs_err_{tag}"] = chip_smoke.compare(
                f"swin_vote_block {tag}", out, ref, chip_smoke.KERNEL_TOL)
        kernel = lambda: swin_block.swin_vote_block(*kargs)
        res[f"device_ms_{tag}"] = chip_smoke.device_ms(kernel)
        res[f"ms_{tag}"] = chip_smoke.cuda_ms(kernel)
    return res


TIMERS = {"stem": time_stem, "scatter_max": time_scatter,
          "swin_attn": time_attn, "swin_block": time_block}


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(TIMERS))
    ap.add_argument("--tree", default=here)
    ap.add_argument("--time-only", action="store_true",
                    help="time the kernel without holding it to its twin")
    args = ap.parse_args()
    sys.path.insert(0, here)
    import chip_smoke

    # partner_tpu_torch comes from the tree: chip_smoke imports it lazily
    sys.path.insert(0, os.path.abspath(args.tree))
    from partner_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ptxas = ptxas_lines(_cuda.library().ptxas_log, ENTRIES[args.kernel])
    for ln in ptxas:
        print(f"ptxas {args.kernel}:", ln, flush=True)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    res = {"kernel": args.kernel, "tree": os.path.abspath(args.tree),
           "card": chip_smoke.gpu_name_and_power_limit(), "ptxas": ptxas}
    res.update(TIMERS[args.kernel](chip_smoke, gen, dev, not args.time_only))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
