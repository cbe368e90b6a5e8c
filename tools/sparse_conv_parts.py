#!/usr/bin/env python3
"""Where the sparse backbone's convs spend their device time on one CUDA
card, stage by stage, beside the least time the card could take.

    python3 tools/sparse_conv_parts.py [--out FILE]

Builds the full-width input of ``chip_smoke.py``'s sparse phase (the
180,000-point sweep through ``dynamic_voxelize`` at the flagship's
150,000 capacity, rows sorted as ``SpMiddleResNetFHD`` sorts them), the
neighbour maps of every resolution (the binary method), and for one conv
of each shape of the backbone (conv_input, the conv1 blocks, each strided
conv and each stage's blocks) times on the device (``chip_smoke.device_ms``,
launches back to back behind a sleep):

- ``SparseConv`` as the port runs it (``models.sparse.gather_padded``, an
  ``index_select``, then ``torch.matmul``), and its two parts alone;
- the same gather by advanced indexing (``padded[idx]``) and by
  ``torch.gather`` on a row-expanded index, for comparison;
- the product in TF32 (``allow_tf32``), for comparison only: the port
  computes in float32 as JAX does;

beside the conv's bound: the bytes the function must move (features and
map read once, the output written once) over the memory rate, against
the multiply-adds the data needs (the neighbours present, not M x K) over
the float32 peak. Prints one JSON line (also written to ``--out``). Needs
a CUDA card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (config, sweep, timing and peaks)


def convs(backbone, feats, coords, mask, input_shape):
    """(name, features (1, N, Cin), nmap (1, M, K), SparseConv) for one conv
    of each shape of the backbone, features at their real widths (random:
    their values do not move the time)."""
    from partner_tpu_torch.models import sparse as sp
    from partner_tpu_torch.models.backbone import sort_rows

    shape = backbone.sparse_shape(input_shape)
    feats, coords, mask = sort_rows(feats, coords, mask, shape)
    nmap = sp.build_subm_neighbor_map(coords, mask, shape)
    g = torch.Generator(device=feats.device).manual_seed(0)
    out = [("conv_input", feats, nmap, backbone.conv_input.SparseConv_0),
           ("conv1 block", torch.randn(feats.shape[:2] + (16,), generator=g,
                                       device=feats.device), nmap,
            backbone.conv1_0.SparseConv_0)]
    cin = 16
    for name in ("conv2", "conv3", "conv4", "extra_conv"):
        st = getattr(backbone, name)
        geom = (st.kernel, st.stride, st.padding)
        x = torch.randn(feats.shape[:2] + (cin,), generator=g,
                        device=feats.device)
        oc, om = sp.downsample_coords(coords, mask, shape, *geom,
                                      coords.shape[1])
        out_shape = sp.strided_out_shape(shape, *geom)
        smap = sp.build_strided_neighbor_map(oc, om, out_shape, coords, mask,
                                             shape, *geom)
        out.append((f"{name} down", x, smap, st.SparseConv_0))
        cin = st.SparseConv_0.kernel.shape[1]
        if st.num_res:
            y = torch.randn(oc.shape[:2] + (cin,), generator=g,
                            device=feats.device)
            out.append((f"{name} block", y,
                        sp.build_subm_neighbor_map(oc, om, out_shape),
                        st.SparseBasicBlock_0.SparseConv_0))
        coords, mask, shape = oc, om, out_shape
    return out


def bound(x, nmap, conv):
    """(ms, "bytes" or "operations") of one conv's function on this map."""
    n = x.shape[1]
    pairs = int((nmap < n).sum())
    cin, cout = x.shape[-1], conv.kernel.shape[1]
    work = {"flops": {"f32": 2 * pairs * cin * cout},
            "bytes": (x.numel() + nmap.shape[1] * cout) * 4
            + nmap.numel() * nmap.element_size() + conv.kernel.numel() * 4}
    return chip_smoke.bound(work), pairs


@torch.no_grad()
def main():
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.models import sparse as sp
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sparse_conv_parts: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    m, tc = chip_smoke.sparse_cfgs()
    vg = m["bbox_head"]["voxel_generator"]
    det = build_detector(m, None, tc, device=dev)
    pts, msk = chip_smoke.synthetic_sweep(np.random.RandomState(
        chip_smoke.SEED), vg["range"], chip_smoke.N_POINTS)
    ex = DeviceVoxelizer(vg, dev, vg["max_voxel_num"])(
        torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev))
    feats = det.module.reader(ex["features"])
    rows = []
    for name, x, nmap, conv in convs(det.module.backbone, feats, ex["coords"],
                                     ex["voxel_mask"], det.module.grid_size):
        b, n, c = x.shape
        padded = torch.cat([x, x.new_zeros(b, 1, c)], 1).reshape(-1, c)
        idx = nmap.long().reshape(-1)
        g = sp.gather_padded(x, nmap).reshape(b, nmap.shape[1], -1)
        w = conv.kernel
        ms = {"conv": chip_smoke.device_ms(lambda: conv(x, nmap)),
              "gather": chip_smoke.device_ms(lambda: sp.gather_padded(
                  x, nmap)),
              "product": chip_smoke.device_ms(lambda: g @ w),
              "gather_indexing": chip_smoke.device_ms(lambda: padded[idx]),
              "gather_torch_gather": chip_smoke.device_ms(
                  lambda: torch.gather(padded, 0, idx[:, None].expand(-1, c)))}
        torch.backends.cuda.matmul.allow_tf32 = True
        ms["product_tf32"] = chip_smoke.device_ms(lambda: g @ w)
        torch.backends.cuda.matmul.allow_tf32 = False
        (b_ms, b_by), pairs = bound(x, nmap, conv)
        rows.append(dict(name=name, n=n, m=nmap.shape[1], k=nmap.shape[2],
                         cin=c, cout=w.shape[1], pairs=pairs,
                         pairs_share=pairs / nmap.numel(), bound_ms=b_ms,
                         bound_by=b_by, **{f"{k}_ms": v
                                           for k, v in ms.items()}))
        print(f"{name}: N {n} -> M {nmap.shape[1]} x K {nmap.shape[2]}, "
              f"Cin {c} -> Cout {w.shape[1]}, {pairs} neighbours "
              f"({pairs / nmap.numel():.3f} of M x K); device ms "
              + ", ".join(f"{k} {v!r}" for k, v in ms.items())
              + f"; bound {b_ms!r} ms by {b_by}", flush=True)
    result = {"card": chip_smoke.gpu_name_and_power_limit(),
              "torch": torch.__version__, "convs": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
