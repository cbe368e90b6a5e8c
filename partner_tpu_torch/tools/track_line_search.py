"""Tracking-gate grid search of the port (counterpart of
``tools/track_line_search.py``).

    python -m partner_tpu_torch.tools.track_line_search --prediction P
        --info_path I --gt_path G [--dataset waymo|nusc] [--config CONFIG]
        [--scores 0.4:0.8:0.05] [--dists 0.5:3.0:0.5] [--match_dist 2.0]

One tracking run (``tools.track.run_tracking``) per (score_thresh,
max_dist) pair, each scored by the local CLEAR-MOT evaluator
(``eval.tracking.mota_evaluate``); prints every point and the best by
MOTA. ``gt_path``: a pickle {token: {centers (M, 3) global, labels (M,),
ids (M,)}}. Host numpy only, so no device flag.

The swept ``dist`` is the first class's gate and the others scale off it:
Waymo's vehicle gate with pedestrian x 0.4 and cyclist x 0.6, as JAX does;
for nuScenes each class takes ``dist x default / 4`` from
``NUSC_CLS_VELOCITY_ERROR`` and its 4 m car gate. (JAX passes the Waymo
keys to the nuScenes tracker, which has no such class.) ``--dataset nusc``
needs ``--config`` for the label names, as ``tools.track`` does.
"""

import argparse
import itertools
import pickle
import sys

import numpy as np

from ..eval.tracking import NUSC_CLS_VELOCITY_ERROR, mota_evaluate
from .track import class_names_of, run_tracking


def _parse_range(spec):
    lo, hi, step = (float(x) for x in spec.split(":"))
    return np.arange(lo, hi + 1e-9, step)


def gates(dataset, dist):
    """The per-class gates of one grid point ``dist``."""
    if dataset == "waymo":
        return {"VEHICLE": dist, "PEDESTRIAN": dist * 0.4,
                "CYCLIST": dist * 0.6}
    car = NUSC_CLS_VELOCITY_ERROR["car"]
    return {c: dist * d / car for c, d in NUSC_CLS_VELOCITY_ERROR.items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prediction", required=True)
    p.add_argument("--info_path", required=True)
    p.add_argument("--gt_path", required=True)
    p.add_argument("--dataset", default="waymo", choices=["waymo", "nusc"])
    p.add_argument("--config", default=None,
                   help="the detector's config (label names; required with "
                        "--dataset nusc)")
    p.add_argument("--scores", default="0.4:0.8:0.05",
                   help="score_thresh sweep lo:hi:step")
    p.add_argument("--dists", default="0.5:3.0:0.5",
                   help="max_dist sweep lo:hi:step (the first class's gate)")
    p.add_argument("--match_dist", type=float, default=2.0,
                   help="MOTA association gate (m)")
    return p.parse_args(argv)


def main(argv=None):
    """-> (best MOTA, its score_thresh, its dist, its mota_evaluate dict)."""
    args = parse_args(argv)
    if args.dataset == "nusc" and args.config is None:
        sys.exit("track_line_search: --dataset nusc names each label by the "
                 "config's class_names; pass --config")
    class_names = class_names_of(args.config) if args.config else None

    with open(args.prediction, "rb") as f:
        detections = pickle.load(f)
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    with open(args.gt_path, "rb") as f:
        gt_frames = pickle.load(f)

    best = None
    for score, dist in itertools.product(_parse_range(args.scores),
                                         _parse_range(args.dists)):
        results = run_tracking(detections, infos, args.dataset,
                               max_dist=gates(args.dataset, dist),
                               score_thresh=float(score),
                               class_names=class_names)
        m = mota_evaluate(results, gt_frames,
                          max_match_dist=args.match_dist)
        print(f"score={score:.2f} dist={dist:.2f} -> MOTA {m['mota']:.4f} "
              f"(miss {m['misses']} fp {m['false_positives']} "
              f"idsw {m['id_switches']})")
        if best is None or m["mota"] > best[0]:
            best = (m["mota"], float(score), float(dist), m)
    print(f"\nbest: MOTA {best[0]:.4f} @ score_thresh={best[1]:.2f} "
          f"max_dist={best[2]:.2f}")
    return best


if __name__ == "__main__":
    main()
