#!/usr/bin/env python3
"""Where the whole-block SwinVote kernel's time goes, by taking parts out.

    python3 tools/block_kernel_parts.py [--work DIR]

A one-off measurement, kept so that its recorded numbers can be rerun: its
cuts are exact text edits of ``csrc/swin_block.cu`` as it stood when the
measurement was made (the kernel with the ``cp.async`` weight ring and
``mma.sync``). Once the kernel's text changes it fails loudly, naming the
text it no longer finds; then rewrite the cuts against the new source or
delete this file, rather than keep it in step with each kernel change.

For each part below, copies ``partner_tpu_torch`` into ``--work`` (default
``block_kernel_parts`` in the temporary directory) with that part cut out of
the kernel, then times the cut kernel with ``tools/kernel_ab.py --kernel
swin_block --time-only`` in its own process, the intact kernel first and
last. The cut kernels compute wrong results on purpose: only their time is
read. The time a part saves is an upper bound on what it costs, since
removing it also shortens the chains around it. Needs a CUDA card; prints
one JSON line per tree and a summary (device ms) as its last line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("partner_tpu_torch", "csrc", "swin_block.cu")

GEMM_MMA = """        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    ++s.t;"""

# part -> edits, each (text, replacement), (start, end, None): cut from
# marker start up to marker end, or (_, marker, text): insert text before
# marker
PARTS = {
    # the tensor-core instructions of the four weight products
    "weight_mma": [(GEMM_MMA, "      }\n    }\n    ++s.t;")],
    # the barrier before each weight tile
    "tile_barriers": [("    cp_async_wait_all();\n    __syncthreads();\n"
                       "    if (s.t + 1",
                       "    cp_async_wait_all();\n    if (s.t + 1")],
    # every cp.async (weights, x, Wv2): the products read stale tiles
    "copies": [('  asm volatile("cp.async.cg.shared.global [%0], [%1], '
                '16;\\n" ::"r"(\n                   smem_addr(dst)),\n'
                '               "l"(src));', "  (void)dst;\n  (void)src;")],
    # the qkv epilogue: bias loads, vote embed, norms, q/k/v stores
    "qkv_epilogue": [("      // the bias of the warp's logits",
                      "      __syncthreads();  // every warp reads all 64",
                      None),
                     ("      // ---- logits l",
                      "      // ---- logits l",
                      "      constexpr int NTK = T / 8 / NQ;\n"
                      "      float2 bb[NTK][2] = {};\n")],
    # the logits' bias loads alone
    "bias_loads": [("          bb[j][rr] = __ldg(reinterpret_cast<const "
                    "float2*>(\n              bw + (rr ? row1 : row0) * T + "
                    "8 * NTK * cq + 8 * j + 2 * t4));",
                    "          bb[j][rr] = make_float2(0.0f, 0.0f);")],
    # the vote embed's multiply-adds
    "vote_embed": [("            e0 = fmaf(vh[kk], w.x, e0);\n"
                    "            e1 = fmaf(vh[kk], w.y, e1);\n", "")],
    # logits, softmax and P . v of every head
    "attention": [("      // ---- logits l", "    }\n\n    // 256-column",
                   None)],
    # the softmax alone (P = the logits)
    "softmax": [("      // ---- P = bf16(softmax(l))",
                 "      // ---- o_h = bf16(P . v)", None),
                ("      // ---- o_h = bf16(P . v)",
                 "      // ---- o_h = bf16(P . v)",
                 "      sts_pair(sq + row0 * SH + 2 * t4, la[0][0], "
                 "la[0][1]);\n")],
    # tanh GELU -> a scale
    "gelu": [("  return v * (0.5f * (1.0f + tanhf(k0 * (v + 0.044715f * "
              "(v * v * v)))));", "  return v * k0;")],
}


def cut(text, edits):
    for a, b, *rest in edits:
        if rest and rest[0] is None:   # cut from marker a up to marker b
            i0 = text.index(a)
            i1 = text.index(b, i0)
            text = text[:i0] + text[i1:]
            continue
        marker = b if rest else a
        if text.count(marker) != 1:
            raise ValueError(f"swin_block.cu no longer holds, once: "
                             f"{marker[:60]!r}")
        text = text.replace(b, rest[0] + b) if rest else text.replace(a, b)
    return text


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                   "block_kernel_parts"))
    args = ap.parse_args()
    with open(os.path.join(HERE, SRC)) as f:
        source = f.read()
    trees = [("intact", HERE)]
    for name, edits in PARTS.items():
        tree = os.path.join(args.work, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(HERE, "partner_tpu_torch"),
                        os.path.join(tree, "partner_tpu_torch"),
                        ignore=shutil.ignore_patterns(".build", "__pycache__"))
        with open(os.path.join(tree, SRC), "w") as f:
            f.write(cut(source, edits))
        trees.append((name, tree))
    trees.append(("intact", HERE))
    ms = {}
    for name, tree in trees:
        out = subprocess.run(
            [sys.executable, os.path.join(HERE, "tools", "kernel_ab.py"),
             "--kernel", "swin_block", "--tree", tree, "--time-only"],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{name}: {out.stdout[-2000:]}"
                               f"{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["part"] = name
        print(json.dumps(res), flush=True)
        ms.setdefault(name, []).append(
            (res["device_ms_shifted"], res["device_ms_unshifted"]))
    print(json.dumps({"card": res["card"], "device_ms_shifted_unshifted": ms}),
          flush=True)


if __name__ == "__main__":
    main()
