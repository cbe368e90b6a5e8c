#!/usr/bin/env python3
"""Time the window-attention kernel of one source tree on one CUDA card.

    python3 tools/attn_kernel_ab.py [--tree DIR] [--time-only]

Imports ``partner_tpu_torch`` from ``--tree`` (default: this repository)
and builds that tree's kernels; the inputs, the check and the timing are
this repository's ``chip_smoke.py``. At the flagship shape (q, k, v (576,
4, 64, 64) bf16, the real cell positions; ``chip_smoke.attn_case``), with
and without the shifted-window mask, it holds the kernel against the
tree's plain twin within ``chip_smoke.KERNEL_TOL``, then times one call
(``ms``: ``chip_smoke.cuda_ms``, the median of single calls, the wrapper's
host time included where it is the longer) and one launch on the device
(``device_ms``: ``chip_smoke.device_ms``, back-to-back launches, warm L2),
beside the kernel's bound (``chip_smoke.bound``) and the device time of
``F.scaled_dot_product_attention`` on the same q, k, v with the bias summed
beforehand (``chip_smoke.attention_library_call``: the attention core
only). Prints the ptxas report of ``swin_attn_kernel`` and, as its last
line, one JSON object. ``--time-only`` skips the check, for a tree whose
kernel was cut on purpose (``tools/attn_kernel_parts.py``).

To compare two commits on one card, unpack the other into a directory
and run both trees in turns in one run (A, B, B, A): times move
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
    from partner_tpu_torch.ops import _cuda, swin_attn

    if not torch.cuda.is_available():
        sys.exit("attn_kernel_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _cuda.library()
    ptxas, entry = [], False
    for ln in lib.ptxas_log.splitlines():
        if "Compiling entry" in ln:
            entry = "swin_attn_kernel" in ln
        if entry and ("Compiling entry" in ln or "registers" in ln
                      or "spill" in ln):
            ptxas.append(ln.strip())
    for ln in ptxas:
        print("ptxas swin_attn_kernel:", ln, flush=True)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    res = {"tree": os.path.abspath(args.tree),
           "card": chip_smoke.gpu_name_and_power_limit(), "ptxas": ptxas}
    for with_mask in (True, False):
        kargs = chip_smoke.attn_case(gen, dev, with_mask)
        tag = "mask" if with_mask else "no_mask"
        if not args.time_only:
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
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
