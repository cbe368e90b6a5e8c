"""Multi-model prediction ensembling with rotated NMS (counterpart of
``tools/nms_ensemble.py``).

    python -m partner_tpu_torch.tools.nms_ensemble out.pkl a.pkl b.pkl
        [--weights 1.0 0.8] [--iou 0.7] [--post 500] [--device cuda|cpu]

Merges several ``prediction.pkl`` files (each model's scores times its
weight) and runs class-aware rotated NMS (``ops.nms.batched_rotated_nms``)
over each frame's union on ``--device``: the card unless ``--device cpu``;
with no card it stops with an error rather than run on the CPU. The kept
indices come back to the host once a frame.
"""

import argparse
import pickle
import sys

import numpy as np


def ensemble(preds_list, weights=None, iou=0.7, post=500, *, device):
    """{token: {box3d_lidar, scores, label_preds}} of each model -> the
    same of the kept boxes, frames in first-seen order; the NMS runs on
    ``device`` (no default: the caller names the card or the CPU)."""
    import torch

    from ..ops.nms import batched_rotated_nms

    weights = weights or [1.0] * len(preds_list)
    tokens = list(dict.fromkeys(t for p in preds_list for t in p))
    out = {}
    for tok in tokens:
        boxes, scores, labels = [], [], []
        for w, p in zip(weights, preds_list):
            if tok not in p:
                continue
            d = p[tok]
            boxes.append(np.asarray(d["box3d_lidar"]))
            scores.append(np.asarray(d["scores"]) * w)
            labels.append(np.asarray(d["label_preds"]))
        b = np.concatenate(boxes)
        s = np.concatenate(scores)
        l = np.concatenate(labels)
        if not len(b):
            out[tok] = {"box3d_lidar": b, "scores": s, "label_preds": l}
            continue
        bev = np.stack([b[:, 0], b[:, 1], b[:, 3], b[:, 4], b[:, -1]], -1)
        keep, kmask = batched_rotated_nms(
            torch.from_numpy(bev.astype(np.float32)).to(device),
            torch.from_numpy(s.astype(np.float32)).to(device),
            torch.from_numpy(l.astype(np.int32)).to(device), iou,
            min(post, len(b)))
        keep, kmask = torch.stack([keep, kmask.to(keep.dtype)]).cpu().numpy()
        keep = keep[kmask.astype(bool)]
        out[tok] = {"box3d_lidar": b[keep], "scores": s[keep],
                    "label_preds": l[keep]}
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("output")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--weights", nargs="*", type=float, default=None)
    p.add_argument("--iou", type=float, default=0.7)
    p.add_argument("--post", type=int, default=500)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """-> the merged predictions."""
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("nms_ensemble: no CUDA device; pass --device cpu to run on "
                 "the CPU")
    preds = []
    for path in args.inputs:
        with open(path, "rb") as f:
            preds.append(pickle.load(f))
    merged = ensemble(preds, args.weights, args.iou, args.post,
                      device=args.device)
    with open(args.output, "wb") as f:
        pickle.dump(merged, f)
    n = sum(len(v["scores"]) for v in merged.values())
    print(f"wrote {n} boxes over {len(merged)} frames -> {args.output}")
    return merged


if __name__ == "__main__":
    main()
