"""Tracking CLI of the port (counterpart of ``tools/track.py``).

    python -m partner_tpu_torch.tools.track --prediction P --info_path I
        [--work_dir tracking_out] [--dataset waymo|nusc] [--config CONFIG]
        [--vehicle D] [--pedestrian D] [--cyclist D] [--score_thresh S]
        [--max_age N]

Loads a ``prediction.pkl`` (token -> detections, the ``dist_test``
output), converts each frame's detections to the global frame with its
pose, runs the greedy velocity tracker per sequence in timestamp order and
writes ``tracking_result.pkl`` ({token: tracking_ids, boxes_global,
scores, labels}); for Waymo also the devkit's ``tracking_pred.bin``
through ``eval.waymo.create_pd_detection(..., tracking=True)``. Host numpy
only: the tool has no device work, so it takes no device flag.

Two repairs against the JAX tool, which ROADMAP.md §3 records:

- nuScenes labels become the config's class names (``--config``, required
  with ``--dataset nusc``), as ``eval.nuscenes.write_nusc_results`` names
  them. JAX names each detection ``str(label)``, which the tracker's name
  gate then drops, every box;
- each frame's pose comes from ``eval.tracking.frame_pose``: the info's
  ``pose``, else Waymo's ``veh_to_global`` or the nuScenes calibration
  chain; an info with none of them stops the run naming the key. JAX takes
  the identity there.

The time lag is the difference of the infos' ``timestamp``, as in JAX.
The Waymo infos of either ``create_data`` carry the frame's index there,
so a lag of 1 is one frame and velocities are read per frame.
"""

import argparse
import os
import pickle
import sys
from collections import defaultdict

import numpy as np

from ..eval.tracking import (WAYMO_TRACKING_NAMES,
                             convert_detection_to_global_box, nusc_tracker,
                             waymo_tracker)


def run_tracking(detections, infos, dataset="waymo", max_dist=None,
                 score_thresh=None, max_age=3, class_names=None):
    """Returns {token: {tracking_ids, boxes_global, scores, labels}}.

    max_dist / score_thresh / max_age override the per-dataset tracker
    gates, the knobs the reference's grid search sweeps. ``class_names``
    (nuScenes, required) names each label."""
    if dataset != "waymo" and class_names is None:
        raise ValueError("nuScenes tracking names each label by the "
                         "config's class names; pass class_names")
    frames = convert_detection_to_global_box(detections, infos)

    # group frames by sequence (token prefix up to _frame_, else one seq)
    seqs = defaultdict(list)
    for fr in frames:
        tok = fr["token"]
        seq = tok.rsplit("_frame_", 1)[0] if "_frame_" in tok else "seq0"
        seqs[seq].append(fr)

    out = {}
    for frs in seqs.values():
        kw = {}
        if score_thresh is not None:
            kw["score_thresh"] = score_thresh
        if dataset == "waymo":
            tracker = waymo_tracker(max_age=max_age, max_dist=max_dist, **kw)
            names = WAYMO_TRACKING_NAMES
        else:
            tracker = nusc_tracker(max_age=max_age, max_dist=max_dist, **kw)
            names = class_names
        last_t = None
        for fr in sorted(frs, key=lambda f: f["timestamp"]):
            time_lag = (0.0 if last_t is None
                        else float(fr["timestamp"] - last_t))
            last_t = fr["timestamp"]
            dets = []
            for i in range(len(fr["scores"])):
                label = int(fr["label_preds"][i])
                if label >= len(names):
                    continue
                dets.append({
                    "translation": fr["global_boxes"][i],
                    "velocity": fr["velocity"][i],
                    "detection_name": names[label],
                    "score": float(fr["scores"][i]),
                })
            tracks = tracker.step(dets, time_lag)
            out[fr["token"]] = {
                "tracking_ids": np.asarray(
                    [t["tracking_id"] for t in tracks], np.int64),
                "boxes_global": np.asarray(
                    [t["translation"] for t in tracks], np.float32).reshape(
                        -1, 3),
                "scores": np.asarray([t["score"] for t in tracks],
                                     np.float32),
                "labels": np.asarray([t["label_preds"] for t in tracks],
                                     np.int64),
            }
    return out


def class_names_of(config):
    """The class names a config's labels index (its ``class_names``)."""
    from ..utils.config import load_config

    return list(load_config(config)["class_names"])


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prediction", required=True)
    p.add_argument("--info_path", required=True)
    p.add_argument("--work_dir", default="./tracking_out")
    p.add_argument("--dataset", default="waymo", choices=["waymo", "nusc"])
    p.add_argument("--config", default=None,
                   help="the detector's config: its class_names name the "
                        "labels (required with --dataset nusc)")
    # per-class association gates + score threshold (reference
    # waymo_tracking/test.py:--vehicle/--pedestrian/--cyclist/--score_thresh)
    p.add_argument("--vehicle", type=float, default=None)
    p.add_argument("--pedestrian", type=float, default=None)
    p.add_argument("--cyclist", type=float, default=None)
    p.add_argument("--score_thresh", type=float, default=None)
    p.add_argument("--max_age", type=int, default=3)
    return p.parse_args(argv)


def main(argv=None):
    """-> the tracking results (as :func:`run_tracking` returns them)."""
    args = parse_args(argv)
    if args.dataset == "nusc" and args.config is None:
        sys.exit("track: --dataset nusc names each label by the config's "
                 "class_names; pass --config")
    class_names = class_names_of(args.config) if args.config else None

    with open(args.prediction, "rb") as f:
        detections = pickle.load(f)
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)

    max_dist = None
    if any(v is not None for v in (args.vehicle, args.pedestrian,
                                   args.cyclist)):
        max_dist = {
            "VEHICLE": args.vehicle if args.vehicle is not None else 2.5,
            "PEDESTRIAN": (args.pedestrian if args.pedestrian is not None
                           else 1.0),
            "CYCLIST": args.cyclist if args.cyclist is not None else 1.5}
    results = run_tracking(detections, infos, args.dataset,
                           max_dist=max_dist, score_thresh=args.score_thresh,
                           max_age=args.max_age, class_names=class_names)

    os.makedirs(args.work_dir, exist_ok=True)
    out_pkl = os.path.join(args.work_dir, "tracking_result.pkl")
    with open(out_pkl, "wb") as f:
        pickle.dump(results, f)
    n = sum(len(r["tracking_ids"]) for r in results.values())
    print(f"wrote {n} tracked boxes over {len(results)} frames -> {out_pkl}")

    if args.dataset == "waymo":
        from ..eval.waymo import create_pd_detection

        dets = {
            tok: {"box3d_lidar": np.concatenate(
                      [r["boxes_global"],
                       np.tile([[4.0, 2.0, 1.6, 0.0]],
                               (len(r["boxes_global"]), 1))], axis=1),
                  "scores": r["scores"],
                  "label_preds": r["labels"],
                  "tracking_ids": r["tracking_ids"]}
            for tok, r in results.items()
        }
        create_pd_detection(dets, infos, args.work_dir, tracking=True)
    return results


if __name__ == "__main__":
    main()
