"""Waymo Open Dataset official-protocol detection metrics (in-framework).

A copy of ``partner_tpu/eval/waymo_protocol.py``: the port imports nothing of
the JAX package, not even its numpy-only modules.

Implements the devkit's evaluation semantics — which the reference defers
to the external `waymo-open-dataset` package (det3d/datasets/waymo/
waymo.py:94-104 serializes bins for it; waymo_decoder.py:174-185 computes
the per-box difficulty it consumes) — so `WaymoDataset.evaluation` can
report real LEVEL_1 / LEVEL_2 AP/APH without the (TF-heavy) devkit:

- **Difficulty**: combined difficulty per gt box = the labeler's
  `detection_difficulty_level` when set, else LEVEL_1 if
  `num_points_in_gt >= 5` else LEVEL_2; boxes with no points are ignored
  entirely (`999`) — waymo_decoder.py:174-185 intended semantics (the
  shipped code has a dead `999` branch; we implement the intent).
- **Matching**: per-frame Hungarian assignment maximizing BEV IoU subject
  to IoU >= class threshold (the devkit's TYPE_HUNGARIAN matcher), re-run
  at every score cutoff like the devkit — a detection surviving the cutoff
  either matches a counted gt (TP), matches an ignorable gt (neither TP
  nor FP), or is an FP.
- **Levels**: LEVEL_1 counts only difficulty-1 gts (difficulty-2 boxes are
  ignorable); LEVEL_2 counts difficulty 1 and 2. `999` is always ignorable.
- **P/R curve**: score cutoffs sampled from the pooled score distribution
  (`num_desired_score_cutoffs`); precision_h = sum(h)/ (TP+FP) and
  recall_h = sum(h)/n_gt where h is 1 for AP and the heading accuracy
  `1 - |wrap(dtheta)| / pi` for APH (the paper's definition).
- **AP integration**: precision envelope (monotone non-increasing in
  recall), integrated as sum(min(delta_recall, recall_delta) * p) with the
  devkit's `desired_recall_delta = 0.05` — recall gaps wider than the
  delta contribute zero precision, penalizing holes in the curve.
- **Range breakdowns**: [0, 30), [30, 50), [50, inf) by BEV center range,
  each evaluated on the det+gt subset inside the shard (the devkit's RANGE
  breakdown generator).

Everything runs on host numpy (+ scipy Hungarian); the IoU kernel is the
shared Green's-theorem rotated-overlap port in eval/detection_metrics.py.
"""

from collections import defaultdict

import numpy as np

from .detection_metrics import bev_iou_matrix

IGNORE_DIFFICULTY = 999
DEFAULT_IOU_THRESHOLDS = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5,
                          "Sign": 0.5}
DEFAULT_RANGES = ((0.0, 30.0), (30.0, 50.0), (50.0, float("inf")))
RECALL_DELTA = 0.05


def combined_difficulty(num_points, labeler_difficulty):
    """Per-box combined difficulty (waymo_decoder.py:174-185 intent).

    num_points: (N,) lidar points in box (-1 = unknown -> treated as
      plenty, i.e. LEVEL_1, matching annos that never recorded counts).
    labeler_difficulty: (N,) raw `detection_difficulty_level` (0 = unset).
    Returns (N,) int: 1, 2, or IGNORE_DIFFICULTY.
    """
    num_points = np.asarray(num_points, np.int64)
    labeler = np.asarray(labeler_difficulty, np.int64)
    by_points = np.where((num_points >= 5) | (num_points < 0), 1, 2)
    out = np.where(labeler != 0, labeler, by_points)
    return np.where(num_points == 0, IGNORE_DIFFICULTY, out)


def _score_cutoffs(all_scores, num_desired=51):
    """Cutoff grid from the pooled score distribution (devkit samples the
    observed scores so every cutoff changes the det subset)."""
    s = np.unique(np.asarray(all_scores, np.float64))
    if len(s) == 0:
        return np.array([0.0])
    if len(s) <= num_desired:
        return s
    q = np.linspace(0.0, 1.0, num_desired)
    return np.unique(np.quantile(s, q, method="nearest"))


def _hungarian_match(iou, thr):
    """Max-IoU assignment with IoU >= thr required; returns det->gt index
    (-1 unmatched). iou: (n_det, n_gt)."""
    n_det, n_gt = iou.shape
    match = np.full(n_det, -1, np.int64)
    if n_det == 0 or n_gt == 0:
        return match
    from scipy.optimize import linear_sum_assignment

    cost = np.where(iou >= thr, -iou, 1e-3)  # disallowed pairs cost > 0
    rows, cols = linear_sum_assignment(cost)
    ok = iou[rows, cols] >= thr
    match[rows[ok]] = cols[ok]
    return match


def _ap_from_pr(recalls, precisions, recall_delta=RECALL_DELTA):
    """Devkit-style AP: precision envelope, recall-delta-capped sum."""
    r = np.asarray(recalls, np.float64)
    p = np.asarray(precisions, np.float64)
    order = np.argsort(r)
    r, p = r[order], p[order]
    # precision envelope: p(r) = max precision at recall >= r
    p = np.maximum.accumulate(p[::-1])[::-1]
    r_prev = np.concatenate([[0.0], r[:-1]])
    gaps = np.minimum(r - r_prev, recall_delta)
    return float(np.sum(gaps * p))


def _heading_accuracy(dt_yaw, gt_yaw):
    d = np.abs(dt_yaw - gt_yaw) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return np.maximum(0.0, 1.0 - d / np.pi)


def _frame_class_arrays(detections, gts, class_names):
    """Pre-split per (token, class): det boxes/scores, gt boxes/difficulty,
    and the (det x gt) IoU matrix — computed once, shared by every score
    cutoff, level, and range shard."""
    per = {}
    iou_thresholds = {}
    for token, det in detections.items():
        gt = gts.get(token, {})
        gt_boxes = np.asarray(gt.get("gt_boxes", np.zeros((0, 7))))
        gt_cls = np.asarray(gt.get("gt_classes", np.zeros((0,), np.int64)))
        n_gt_all = len(gt_boxes)
        npts = np.asarray(gt.get("num_points",
                                 -np.ones((n_gt_all,), np.int64)))
        ldiff = np.asarray(gt.get("difficulty",
                                  np.zeros((n_gt_all,), np.int64)))
        diff = combined_difficulty(npts, ldiff)
        boxes = np.asarray(det["box3d_lidar"])
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        for ci, cname in enumerate(class_names):
            db = boxes[labels == ci]
            ds = scores[labels == ci]
            gb = gt_boxes[gt_cls == ci]
            gd = diff[gt_cls == ci]
            if len(db) == 0 and len(gb) == 0:
                continue
            per[(token, cname)] = {
                "det_boxes": db, "det_scores": ds,
                "det_range": (np.linalg.norm(db[:, :2], axis=1)
                              if len(db) else np.zeros((0,))),
                "gt_boxes": gb, "gt_diff": gd,
                "gt_range": (np.linalg.norm(gb[:, :2], axis=1)
                             if len(gb) else np.zeros((0,))),
                "iou": bev_iou_matrix(db, gb),
            }
    return per


def waymo_official_metrics(detections, gts, class_names, iou_thresholds=None,
                           num_score_cutoffs=51, ranges=DEFAULT_RANGES,
                           recall_delta=RECALL_DELTA):
    """Official-protocol Waymo AP/APH with LEVEL_1/LEVEL_2 + range shards.

    detections: {token: {box3d_lidar (N, >=7), scores, label_preds}}
    gts: {token: {gt_boxes (M, >=7), gt_classes (M,), num_points (M,)?,
                  difficulty (M,)?}} — yaw in the LAST box column.
    Returns a flat dict: 'AP/L1/<cls>', 'APH/L2/<cls>',
    'APH/L2/<cls>/[30,50)', 'mAP/L1', 'mAPH/L2', ...
    """
    iou_thresholds = iou_thresholds or DEFAULT_IOU_THRESHOLDS
    per = _frame_class_arrays(detections, gts, class_names)

    shards = [("", None)] + [
        (f"/[{lo:g},{hi:g})" if np.isfinite(hi) else f"/[{lo:g},inf)",
         (lo, hi))
        for lo, hi in ranges
    ]

    out = {}
    level_accum = {1: defaultdict(list), 2: defaultdict(list)}
    for cname in class_names:
        thr = iou_thresholds.get(cname, 0.5)
        entries = [v for (t, c), v in per.items() if c == cname]
        if not entries:
            continue
        pooled_scores = (np.concatenate([e["det_scores"] for e in entries])
                         if entries else np.zeros((0,)))
        cutoffs = _score_cutoffs(pooled_scores, num_score_cutoffs)

        for shard_name, shard in shards:
            # stats[level] rows: per-cutoff [sum_h_ap, sum_h_aph, tp+fp, n_gt]
            stats = {1: np.zeros((len(cutoffs), 4)),
                     2: np.zeros((len(cutoffs), 4))}
            for e in entries:
                if shard is None:
                    dm = np.ones(len(e["det_boxes"]), bool)
                    gm = np.ones(len(e["gt_boxes"]), bool)
                else:
                    lo, hi = shard
                    dm = (e["det_range"] >= lo) & (e["det_range"] < hi)
                    gm = (e["gt_range"] >= lo) & (e["gt_range"] < hi)
                db, ds = e["det_boxes"][dm], e["det_scores"][dm]
                gb, gd = e["gt_boxes"][gm], e["gt_diff"][gm]
                iou = e["iou"][np.ix_(dm, gm)]
                n_gt_l1 = int((gd == 1).sum())
                n_gt_l2 = int(((gd == 1) | (gd == 2)).sum())
                for k, cut in enumerate(cutoffs):
                    keep = ds >= cut
                    match = _hungarian_match(iou[keep], thr)
                    mdiff = (np.where(match >= 0, gd[match], 0)
                             if len(gd) else np.zeros(len(match), np.int64))
                    h = np.zeros(len(match))
                    if (match >= 0).any():
                        ok = match >= 0
                        h[ok] = _heading_accuracy(db[keep][ok][:, -1],
                                                  gb[match[ok]][:, -1])
                    for level in (1, 2):
                        counted = (match >= 0) & (mdiff <= level)
                        ignored = (match >= 0) & ~counted
                        n_pred = int(keep.sum() - ignored.sum())
                        n_gt = n_gt_l1 if level == 1 else n_gt_l2
                        stats[level][k] += [counted.sum(),
                                            h[counted].sum(), n_pred, n_gt]

            for level in (1, 2):
                s = stats[level]
                n_gt = s[0, 3]
                if n_gt == 0:
                    continue
                with np.errstate(invalid="ignore", divide="ignore"):
                    prec_ap = np.where(s[:, 2] > 0, s[:, 0] / s[:, 2], 0.0)
                    prec_aph = np.where(s[:, 2] > 0, s[:, 1] / s[:, 2], 0.0)
                rec_ap = s[:, 0] / n_gt
                rec_aph = s[:, 1] / n_gt
                ap = _ap_from_pr(rec_ap, prec_ap, recall_delta)
                aph = _ap_from_pr(rec_aph, prec_aph, recall_delta)
                out[f"AP/L{level}/{cname}{shard_name}"] = ap
                out[f"APH/L{level}/{cname}{shard_name}"] = aph
                if shard_name == "":
                    level_accum[level]["ap"].append(ap)
                    level_accum[level]["aph"].append(aph)

    for level in (1, 2):
        aps = level_accum[level]["ap"]
        out[f"mAP/L{level}"] = float(np.mean(aps)) if aps else float("nan")
        aphs = level_accum[level]["aph"]
        out[f"mAPH/L{level}"] = float(np.mean(aphs)) if aphs else float("nan")
    return out
