#!/usr/bin/env python3
"""Where the window-attention kernel's time goes, by changing parts of it.

    python3 tools/attn_kernel_parts.py [--work DIR]

A one-off measurement, kept so that its recorded numbers can be rerun: its
edits are exact text edits of ``csrc/swin_attn.cu`` as it stood when the
measurement was made (one block per window, ``mma.sync``, the shared RPE
table). Once the kernel's text changes it fails loudly, naming the text it
no longer finds; then rewrite the edits against the new source or delete
this file, rather than keep it in step with each kernel change.

For each variant below, copies ``partner_tpu_torch`` into ``--work``
(default ``attn_kernel_parts`` in the temporary directory) with the
kernel's text edited, then times it with ``tools/kernel_ab.py --kernel
swin_attn --time-only`` in its own process, the intact kernel first and
last. The cuts compute wrong results on purpose: only their time is read. The time a cut saves is an upper bound on what the
part costs, since removing it also shortens the chains around it. Needs a
CUDA card; prints one JSON line per tree and a summary (device ms, mask /
no mask) as its last line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("partner_tpu_torch", "csrc", "swin_attn.cu")

# variant -> edits, each (text, replacement)
VARIANTS = {
    # the RPE MLP of the table fill (the table then holds b2)
    "rpe_mlp": [("    for (int kk = 0; kk < HID; ++kk) {",
                 "    for (int kk = 0; kk < 0; ++kk) {")],
    # every cp.async: the kernel computes on whatever shared memory holds
    "copies": [('  asm volatile("cp.async.cg.shared.global [%0], [%1], '
                '16;\\n" ::"r"(\n                   smem_addr(dst)),\n'
                '               "l"(src));', "  (void)dst;\n  (void)src;")],
    # the row norms (the sums of squares)
    "norms": [("    for (int c = 0; c < HD / 8; ++c) {\n      const uint4",
               "    for (int c = 0; c < 0; ++c) {\n      const uint4")],
    # the q . k^T tensor-core instructions (the logits are then the bias)
    "qk_mma": [("        mma_bf16(acc[j], a, b[0], b[1]);\n"
                "        mma_bf16(acc[j + 1], a, b[2], b[3]);\n", "")],
    # expf of the softmax (P = the normalised logits)
    "exp": [("      acc[j][2 * r] = expf(acc[j][2 * r] - m);\n"
             "      acc[j][2 * r + 1] = expf(acc[j][2 * r + 1] - m);",
             "      acc[j][2 * r] = acc[j][2 * r] - m;\n"
             "      acc[j][2 * r + 1] = acc[j][2 * r + 1] - m;")],
    # not a cut: the twin's IEEE divisions in place of the reciprocals
    "ieee_divisions": [
        ("    snorm[tid] = 1.0f / (tid < NH * T ? n * spar[PAR_TAU + r / T]"
         " : n);", "    snorm[tid] = n;"),
        ("        float l0 = acc[j][2 * r] * qni * knj.x + bias.x;\n"
         "        float l1 = acc[j][2 * r + 1] * qni * knj.y + bias.y;",
         "        const float tau_h = spar[PAR_TAU + h];\n"
         "        float l0 = acc[j][2 * r] / (qni * knj.x) / tau_h"
         " + bias.x;\n"
         "        float l1 = acc[j][2 * r + 1] / (qni * knj.y) / tau_h"
         " + bias.y;"),
        ("    const float rs = 1.0f / quad_sum(t[0]);",
         "    const float rs = quad_sum(t[0]);"),
        ("pack_bf16(acc[j][2 * r] * rs, acc[j][2 * r + 1] * rs)",
         "pack_bf16(acc[j][2 * r] / rs, acc[j][2 * r + 1] / rs)")],
}


def edit(text, edits):
    for a, b in edits:
        if text.count(a) != 1:
            raise ValueError(f"swin_attn.cu no longer holds, once: {a[:60]!r}")
        text = text.replace(a, b)
    return text


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                   "attn_kernel_parts"))
    args = ap.parse_args()
    with open(os.path.join(HERE, SRC)) as f:
        source = f.read()
    trees = [("intact", HERE)]
    for name, edits in VARIANTS.items():
        tree = os.path.join(args.work, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(HERE, "partner_tpu_torch"),
                        os.path.join(tree, "partner_tpu_torch"),
                        ignore=shutil.ignore_patterns(".build", "__pycache__"))
        with open(os.path.join(tree, SRC), "w") as f:
            f.write(edit(source, edits))
        trees.append((name, tree))
    trees.append(("intact", HERE))
    ms = {}
    for name, tree in trees:
        out = subprocess.run(
            [sys.executable, os.path.join(HERE, "tools", "kernel_ab.py"),
             "--kernel", "swin_attn", "--tree", tree, "--time-only"],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{name}: {out.stdout[-2000:]}"
                               f"{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["variant"] = name
        print(json.dumps(res), flush=True)
        ms.setdefault(name, []).append(
            (res["device_ms_mask"], res["device_ms_no_mask"]))
    print(json.dumps({"card": res["card"], "device_ms_mask_no_mask": ms}),
          flush=True)


if __name__ == "__main__":
    main()
