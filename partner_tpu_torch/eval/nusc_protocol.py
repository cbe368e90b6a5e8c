"""nuScenes devkit-faithful detection metrics (in-framework).

A copy of ``partner_tpu/eval/nusc_protocol.py``: the port imports nothing of
the JAX package, not even its numpy-only modules.

Implements the nuscenes-devkit evaluation algorithm (`nuscenes/eval/
detection/algo.py` semantics) that the reference relied on externally (its
NuScenesDataset module is absent from the release; SURVEY.md section 0).
Compared to the quick approximation in eval/detection_metrics.py, this
module reproduces the devkit's protocol exactly:

- **Class-range filtering**: gts and dets outside the class-specific
  range (car 50 m, pedestrian 40 m, cone 30 m, ...) are dropped first.
- **Matching** (accumulate): detections of a class are pooled over ALL
  samples and walked in descending score order; each matches the closest
  not-yet-taken gt of the class in its own sample if the 2D center
  distance < threshold. One pass per threshold in {0.5, 1, 2, 4} m.
- **101-point interpolation**: precision and confidence are interpolated
  onto recall = linspace(0, 1, 101) with right-fill 0.
- **AP clipping** (calc_ap): operating points below 10% recall or 10%
  precision are removed: AP = mean(max(p - 0.1, 0)) / (1 - 0.1) over the
  recall bins above 0.1.
- **TP errors** (calc_tp): ATE / ASE / AOE / AVE (+AAE when attributes
  exist) are cumulative means over TPs at the 2 m threshold, interpolated
  onto the recall grid, then averaged between 10% recall and the max
  achieved recall; classes where a metric is undefined (barrier AVE,
  traffic_cone AOE/AVE) are excluded via NaN, exactly like the devkit.
- **NDS** = (mean_ap_weight * mAP + sum(max(0, 1 - err))) /
  (mean_ap_weight + n_tp_metrics) with mean_ap_weight = 5. The devkit's 5
  TP metrics include AAE; when no attribute data exists we compute NDS
  over the 4 available metrics and report `nds_tp_metrics` so the number
  is labeled.

All host numpy; boxes are (N, 9) [x, y, z, dx, dy, dz, vx, vy, yaw] (7-col
boxes work too — velocity errors are then skipped).
"""

from collections import defaultdict

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MEAN_AP_WEIGHT = 5
N_RECALL_BINS = 101

# devkit detection_cvpr_2019 class ranges (meters)
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 55.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
# classes where a TP metric is undefined (devkit LEAVES them out of means)
NO_ORIENT = {"traffic_cone"}
ORIENT_PERIOD_PI = {"barrier"}  # orientation error modulo pi
NO_VELOCITY = {"barrier", "traffic_cone"}


def _wrap_angle(d, period):
    d = np.abs(d) % period
    return np.minimum(d, period - d)


def _cummean(x):
    """Devkit cummean: cumulative mean ignoring NaNs (NaN -> 1 when the
    prefix has no valid entries)."""
    x = np.asarray(x, np.float64)
    ok = ~np.isnan(x)
    cnt = np.cumsum(ok)
    s = np.cumsum(np.where(ok, x, 0.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        out = s / cnt
    return np.where(cnt == 0, 1.0, out)


def accumulate(dets, gts_by_token, cname, dist_th, with_tp_errors):
    """One (class, dist threshold) accumulation; devkit algo.py semantics.

    dets: list of rows {token, score, xy (2,), box (>=7,), vel (2,)|None}
      for this class, already range-filtered.
    gts_by_token: {token: {"xy": (M, 2), "box": (M, >=7), "vel": (M, 2)}}
      for this class, range-filtered.
    Returns a MetricData dict on the 101-recall grid, or None if no gts.
    """
    npos = sum(len(g["xy"]) for g in gts_by_token.values())
    if npos == 0:
        return None
    if not dets:
        # gts but no predictions of this class: zero curve everywhere
        md = {"recall": np.linspace(0, 1, N_RECALL_BINS),
              "precision": np.zeros(N_RECALL_BINS),
              "confidence": np.zeros(N_RECALL_BINS), "npos": npos}
        if with_tp_errors:
            for k in ("trans", "scale", "orient", "vel"):
                md[k + "_err"] = np.ones(N_RECALL_BINS)
        return md
    order = np.argsort([-d["score"] for d in dets], kind="stable")
    taken = defaultdict(set)
    tp, fp, conf = [], [], []
    err = {"trans": [], "scale": [], "orient": [], "vel": []}
    for i in order:
        d = dets[i]
        g = gts_by_token.get(d["token"])
        best_j, best_dist = -1, float(dist_th)
        if g is not None and len(g["xy"]):
            dist = np.linalg.norm(g["xy"] - d["xy"][None], axis=1)
            dist[list(taken[d["token"]])] = np.inf
            j = int(np.argmin(dist))
            if dist[j] < best_dist:
                best_j, best_dist = j, dist[j]
        conf.append(d["score"])
        if best_j >= 0:
            taken[d["token"]].add(best_j)
            tp.append(1)
            fp.append(0)
            if with_tp_errors:
                gb = g["box"][best_j]
                db = d["box"]
                err["trans"].append(best_dist)
                # ASE: 1 - iou of center/yaw-aligned boxes
                mins = np.minimum(db[3:6], gb[3:6])
                inter = np.prod(mins)
                union = np.prod(db[3:6]) + np.prod(gb[3:6]) - inter
                err["scale"].append(1.0 - inter / max(union, 1e-8))
                if cname in NO_ORIENT:
                    err["orient"].append(np.nan)
                else:
                    period = np.pi if cname in ORIENT_PERIOD_PI else 2 * np.pi
                    err["orient"].append(
                        float(_wrap_angle(db[-1] - gb[-1], period)))
                if cname in NO_VELOCITY or d["vel"] is None or \
                        g["vel"] is None:
                    err["vel"].append(np.nan)
                else:
                    err["vel"].append(float(np.linalg.norm(
                        d["vel"] - g["vel"][best_j])))
        else:
            tp.append(0)
            fp.append(1)
            if with_tp_errors:
                for k in err:
                    err[k].append(np.nan)

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    conf = np.asarray(conf, np.float64)
    prec = tp / (tp + fp)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, N_RECALL_BINS)
    md = {
        "recall": rec_interp,
        "precision": np.interp(rec_interp, rec, prec, right=0),
        "confidence": np.interp(rec_interp, rec, conf, right=0),
        "npos": npos,
    }
    if with_tp_errors:
        for k, v in err.items():
            # errors are conf-indexed cummeans over matched dets only
            # (devkit keeps only match_data rows for TPs)
            rows = [(c, e) for c, e, t in zip(conf, v, tp_flags(tp)) if t]
            if rows and not np.all(np.isnan([r[1] for r in rows])):
                c_arr = np.array([r[0] for r in rows])
                e_arr = _cummean(np.array([r[1] for r in rows]))
                md[k + "_err"] = np.interp(
                    md["confidence"][::-1], c_arr[::-1], e_arr[::-1]
                )[::-1]
            else:
                # metric undefined for this class/data (e.g. 7-col boxes
                # carry no velocity): exclude from the means, like the
                # devkit's nan handling — unless there were simply no TPs
                # at all, where the devkit's 1.0 convention applies via
                # calc_tp's last_ind < first_ind branch.
                md[k + "_err"] = (np.ones(N_RECALL_BINS) if not rows
                                  else None)
    return md


def tp_flags(tp_cumsum):
    """Recover per-det TP 0/1 flags from the cumsum."""
    prev = np.concatenate([[0.0], tp_cumsum[:-1]])
    return (tp_cumsum - prev) > 0


def calc_ap(md, min_recall=MIN_RECALL, min_precision=MIN_PRECISION):
    """Devkit calc_ap: clip low recall AND low precision, renormalize."""
    prec = np.copy(md["precision"])
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md, metric, min_recall=MIN_RECALL):
    """Devkit calc_tp: mean error between min recall and max achieved
    recall (1.0 when the class never reaches min recall)."""
    conf = md["confidence"]
    nz = np.nonzero(conf)[0]
    last_ind = int(nz[-1]) if len(nz) else 0
    first_ind = round(100 * min_recall) + 1
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md[metric][first_ind:last_ind + 1]))


def _collect(detections, gts, class_names):
    """Range-filter and split per class; returns (dets_by_class,
    gts_by_class_token)."""
    dets_by_class = defaultdict(list)
    gts_by_class = defaultdict(dict)
    for token, gt in gts.items():
        boxes = np.asarray(gt.get("gt_boxes", np.zeros((0, 9))))
        cls = np.asarray(gt.get("gt_classes", np.zeros((0,), np.int64)))
        for ci, cname in enumerate(class_names):
            rng = CLASS_RANGE.get(cname, 50.0)
            m = cls == ci
            b = boxes[m]
            if len(b):
                inside = np.linalg.norm(b[:, :2], axis=1) <= rng
                b = b[inside]
            vel = b[:, 6:8] if b.shape[1] >= 9 else None
            gts_by_class[cname][token] = {
                "xy": b[:, :2] if len(b) else np.zeros((0, 2)),
                "box": b, "vel": vel,
            }
    for token, det in detections.items():
        boxes = np.asarray(det["box3d_lidar"])
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        for ci, cname in enumerate(class_names):
            rng = CLASS_RANGE.get(cname, 50.0)
            for i in np.where(labels == ci)[0]:
                b = boxes[i]
                if np.linalg.norm(b[:2]) > rng:
                    continue
                dets_by_class[cname].append({
                    "token": token, "score": float(scores[i]),
                    "xy": b[:2], "box": b,
                    "vel": b[6:8] if len(b) >= 9 else None,
                })
    return dets_by_class, gts_by_class


def nusc_official_metrics(detections, gts, class_names,
                          dist_thresholds=DIST_THRESHOLDS,
                          dist_th_tp=DIST_TH_TP):
    """Full devkit-protocol evaluation.

    detections: {token: {box3d_lidar (N, 7|9), scores, label_preds}}
    gts: {token: {gt_boxes (M, 7|9), gt_classes}}
    Returns {'AP/<cls>': ..., 'ATE/<cls>': ..., 'mAP', 'mATE', 'mASE',
    'mAOE', 'mAVE', 'NDS', 'nds_tp_metrics'}.
    """
    dets_by_class, gts_by_class = _collect(detections, gts, class_names)

    out = {}
    class_aps, tp_errors = {}, defaultdict(dict)
    for cname in class_names:
        gtc = gts_by_class.get(cname, {})
        detc = dets_by_class.get(cname, [])
        aps = []
        for th in dist_thresholds:
            md = accumulate(detc, gtc, cname, th,
                            with_tp_errors=(th == dist_th_tp))
            if md is None:
                aps = None
                break
            aps.append(calc_ap(md))
            if th == dist_th_tp:
                for key, name in (("trans_err", "ATE"), ("scale_err", "ASE"),
                                  ("orient_err", "AOE"), ("vel_err", "AVE")):
                    skip = (name == "AOE" and cname in NO_ORIENT) or (
                        name == "AVE" and cname in NO_VELOCITY) or (
                        md.get(key) is None)
                    tp_errors[name][cname] = (
                        np.nan if skip else calc_tp(md, key))
        if aps is None:
            continue
        class_aps[cname] = float(np.mean(aps))
        out[f"AP/{cname}"] = class_aps[cname]
        for name, per_cls in tp_errors.items():
            if cname in per_cls:
                out[f"{name}/{cname}"] = float(per_cls[cname])

    mean_ap = float(np.mean(list(class_aps.values()))) if class_aps else 0.0
    out["mAP"] = mean_ap
    tp_scores = []
    used = []
    for name in ("ATE", "ASE", "AOE", "AVE"):
        vals = [v for v in tp_errors[name].values()]
        if not vals or np.all(np.isnan(vals)):
            continue
        mean_err = float(np.nanmean(vals))
        out[f"m{name}"] = mean_err
        tp_scores.append(max(0.0, 1.0 - mean_err))
        used.append(name)
    nds = ((MEAN_AP_WEIGHT * mean_ap + sum(tp_scores))
           / (MEAN_AP_WEIGHT + len(tp_scores))) if (tp_scores or mean_ap) \
        else 0.0
    out["NDS"] = float(nds)
    out["nds_tp_metrics"] = ",".join(used)
    return out
