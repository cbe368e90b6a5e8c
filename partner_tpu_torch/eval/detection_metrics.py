"""Detection metrics computed locally (no external devkit).

A copy of ``partner_tpu/eval/detection_metrics.py``: the port imports nothing of
the JAX package, not even its numpy-only modules.

Replaces the reference's externally-run evaluators with in-framework
equivalents so `dataset.evaluation(...)` returns real numbers:

- Waymo-style AP / APH at class-specific BEV IoU thresholds, with greedy
  score-ordered matching (the matching scheme of the waymo-open-dataset
  metrics and of det3d's KITTI-style kernels,
  the reference's det3d/datasets/utils/eval.py:139-367).
- nuScenes-style center-distance mAP (0.5/1/2/4 m), TP errors
  (ATE/ASE/AOE/AVE) and the NDS aggregate, following the public metric
  definitions the nusc devkit implements.

Everything is vectorized numpy on host (eval is offline); the rotated IoU
is the same Green's-theorem kernel as the device NMS (ops/rotated_iou.py),
ported to numpy.
"""

from collections import defaultdict

import numpy as np

_CORNER_TMPL = np.array(
    [[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], np.float32)


def _clip_aa_np(p0, p1, h, eps_par=1e-5, eps_c=1e-4):
    a = p0
    d = p1 - p0
    hi = np.broadcast_to(h[..., None, :], a.shape)
    lo = -hi
    parallel = np.abs(d) < eps_par
    dd = np.where(parallel, 1.0, d)
    t_lo = (lo - a) / dd
    t_hi = (hi - a) / dd
    t_in = np.minimum(t_lo, t_hi)
    t_out = np.maximum(t_lo, t_hi)
    outside = (a < lo - eps_c) | (a > hi + eps_c)
    on_bound = parallel & ~outside & (
        (np.abs(a - lo) <= eps_c) | (np.abs(a - hi) <= eps_c))
    big = 1e9
    t_in = np.where(parallel, np.where(outside, big, -big), t_in)
    t_out = np.where(parallel, np.where(outside, -big, big), t_out)
    t0 = np.clip(t_in.max(-1), 0.0, 1.0)
    t1 = np.clip(t_out.min(-1), 0.0, 1.0)
    valid = t0 < t1
    weight = valid.astype(np.float32) * np.where(on_bound.any(-1), 0.5, 1.0)
    return t0, t1, weight


def rect_intersection_area_np(box_a, box_b):
    """Exact rotated-rect intersection area, numpy (see ops/rotated_iou.py
    rect_intersection_area_green). box_a, box_b: (..., 5) broadcastable."""
    box_a, box_b = np.broadcast_arrays(box_a, box_b)
    dth = box_a[..., 4] - box_b[..., 4]
    c, s = np.cos(dth), np.sin(dth)
    cb_, sb_ = np.cos(box_b[..., 4]), np.sin(box_b[..., 4])
    dxy = box_a[..., :2] - box_b[..., :2]
    t_ab = np.stack([dxy[..., 0] * cb_ + dxy[..., 1] * sb_,
                     -dxy[..., 0] * sb_ + dxy[..., 1] * cb_], -1)
    ha = box_a[..., 2:4] * 0.5
    hb = box_b[..., 2:4] * 0.5
    ca_loc = _CORNER_TMPL * ha[..., None, :]
    cb_loc = _CORNER_TMPL * hb[..., None, :]

    def rot(p, c, s):
        return np.stack([p[..., 0] * c[..., None] - p[..., 1] * s[..., None],
                         p[..., 0] * s[..., None] + p[..., 1] * c[..., None]],
                        -1)

    ca_in_b = rot(ca_loc, c, s) + t_ab[..., None, :]
    t_ba = rot((-t_ab)[..., None, :], c, -s)[..., 0, :]
    cb_in_a = rot(cb_loc, c, -s) + t_ba[..., None, :]

    a0, a1 = ca_in_b, np.roll(ca_in_b, -1, axis=-2)
    ta0, ta1, wa = _clip_aa_np(a0, a1, hb)
    b0a, b1a = cb_in_a, np.roll(cb_in_a, -1, axis=-2)
    tb0, tb1, wb = _clip_aa_np(b0a, b1a, ha)
    b0, b1 = np.broadcast_arrays(cb_loc, np.roll(cb_loc, -1, axis=-2))

    def contrib(p0, p1, t0, t1, w):
        q0 = p0 + t0[..., None] * (p1 - p0)
        q1 = p0 + t1[..., None] * (p1 - p0)
        cr = q0[..., 0] * q1[..., 1] - q0[..., 1] * q1[..., 0]
        return (w * cr).sum(-1)

    return 0.5 * np.abs(contrib(a0, a1, ta0, ta1, wa)
                        + contrib(b0, b1, tb0, tb1, wb))


def bev_iou_matrix(boxes_a, boxes_b):
    """(N, 7+) x (M, 7+) -> (N, M) rotated BEV IoU. Boxes
    [x, y, z, dx, dy, dz, yaw] (velocity columns allowed in between)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    bev = lambda b: np.stack(
        [b[:, 0], b[:, 1], b[:, 3], b[:, 4], b[:, -1]], -1)
    a, b = bev(np.asarray(boxes_a)), bev(np.asarray(boxes_b))
    inter = rect_intersection_area_np(a[:, None, :], b[None, :, :])
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, 1e-8)


def _greedy_match(scores, affinity, thr, larger_is_better=True):
    """Score-ordered greedy matching of dets to gts.

    affinity (N_det, N_gt); a det matches the best still-unmatched gt with
    affinity better than thr. Returns (matched_gt_idx (N_det,) int, -1 for
    unmatched).
    """
    n_det, n_gt = affinity.shape
    matched = np.full(n_det, -1, np.int64)
    if n_gt == 0 or n_det == 0:
        return matched
    taken = np.zeros(n_gt, bool)
    aff = affinity if larger_is_better else -affinity
    t = thr if larger_is_better else -thr
    for i in np.argsort(-np.asarray(scores)):
        cand = np.where(taken, -np.inf, aff[i])
        j = int(np.argmax(cand))
        if cand[j] >= t:
            matched[i] = j
            taken[j] = True
    return matched


def _pr_from_matches(scores, tp_weight, n_gt):
    """PR curve + all-point AP from pooled per-det (score, tp weight).

    tp_weight in [0, 1]: 1 for a plain TP; the heading-accuracy weight for
    APH. Returns (ap, aph-style weighted ap is whatever weights encode).
    """
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    w = np.asarray(tp_weight, np.float64)[order]
    tp_cum = np.cumsum(w)
    fp_cum = np.cumsum(w == 0.0)  # any non-TP det is a full FP
    # precision uses the weighted tp against total predictions so heading
    # errors also reduce precision (waymo APH semantics)
    denom = np.arange(1, len(w) + 1, dtype=np.float64)
    precision = tp_cum / denom
    recall = tp_cum / n_gt
    # all-point interpolation: make precision monotone, integrate over recall
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - r_prev) * precision))


DEFAULT_IOU_THRESHOLDS = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}


def waymo_ap_aph(detections, gts, class_names,
                 iou_thresholds=None):
    """Waymo-style AP / APH per class over a frame dict.

    detections: {token: {box3d_lidar (N, 7|9), scores, label_preds}}
    gts: {token: {gt_boxes (M, 7|9), gt_classes (M,) int}} (class ids are
      indices into class_names)
    Returns {"AP/<cls>": v, "APH/<cls>": v, "mAP": v, "mAPH": v}.
    """
    iou_thresholds = iou_thresholds or DEFAULT_IOU_THRESHOLDS
    pooled = defaultdict(lambda: {"scores": [], "w": [], "n_gt": 0})

    for token, det in detections.items():
        gt = gts.get(token, {})
        gt_boxes = np.asarray(gt.get("gt_boxes", np.zeros((0, 7))))
        gt_cls = np.asarray(gt.get("gt_classes", np.zeros((0,), np.int64)))
        boxes = np.asarray(det["box3d_lidar"])
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        for ci, cname in enumerate(class_names):
            thr = iou_thresholds.get(cname, 0.5)
            dm = labels == ci
            gm = gt_cls == ci
            db, ds = boxes[dm], scores[dm]
            gb = gt_boxes[gm]
            pooled[cname]["n_gt"] += len(gb)
            if len(db) == 0:
                continue
            iou = bev_iou_matrix(db, gb)
            match = _greedy_match(ds, iou, thr)
            w_ap = (match >= 0).astype(np.float64)
            # heading accuracy weight: 1 - |dtheta| / pi (wrapped)
            w_aph = np.zeros_like(w_ap)
            ok = match >= 0
            if ok.any():
                dt = db[ok, -1] - gb[match[ok], -1]
                dt = np.abs((dt + np.pi) % (2 * np.pi) - np.pi)
                w_aph[ok] = np.maximum(0.0, 1.0 - dt / np.pi)
            pooled[cname]["scores"].append(np.stack([ds, w_ap, w_aph], -1))

    out = {}
    aps, aphs = [], []
    for cname, acc in pooled.items():
        rows = (np.concatenate(acc["scores"])
                if acc["scores"] else np.zeros((0, 3)))
        ap = _pr_from_matches(rows[:, 0], rows[:, 1], acc["n_gt"])
        aph = _pr_from_matches(rows[:, 0], rows[:, 2], acc["n_gt"])
        out[f"AP/{cname}"] = ap
        out[f"APH/{cname}"] = aph
        if not np.isnan(ap):
            aps.append(ap)
            aphs.append(aph)
    out["mAP"] = float(np.mean(aps)) if aps else float("nan")
    out["mAPH"] = float(np.mean(aphs)) if aphs else float("nan")
    return out


NUSC_DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)


def nusc_map_nds(detections, gts, class_names,
                 dist_thresholds=NUSC_DIST_THRESHOLDS, tp_dist=2.0):
    """nuScenes-style mAP (center distance) + TP errors + NDS.

    Follows the public nuScenes detection metric definitions: per-class AP
    averaged over center-distance thresholds; ATE (m) / ASE (1-iou of
    aligned boxes) / AOE (rad) / AVE (m/s) averaged over TPs at the 2 m
    threshold; NDS = (5*mAP + sum(1 - min(1, err))) / (5 + n_tp_metrics).
    """
    pooled = defaultdict(lambda: {"rows": [], "n_gt": 0, "tp_err": []})

    for token, det in detections.items():
        gt = gts.get(token, {})
        gt_boxes = np.asarray(gt.get("gt_boxes", np.zeros((0, 9))))
        gt_cls = np.asarray(gt.get("gt_classes", np.zeros((0,), np.int64)))
        boxes = np.asarray(det["box3d_lidar"])
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        for ci, _ in enumerate(class_names):
            dm = labels == ci
            gm = gt_cls == ci
            db, ds = boxes[dm], scores[dm]
            gb = gt_boxes[gm]
            key = ci
            pooled[key]["n_gt"] += len(gb)
            if len(db) == 0:
                continue
            if len(gb):
                dist = np.linalg.norm(
                    db[:, None, :2] - gb[None, :, :2], axis=-1)
            else:
                dist = np.zeros((len(db), 0))
            row = [ds]
            for thr in dist_thresholds:
                match = _greedy_match(ds, dist, thr, larger_is_better=False)
                row.append((match >= 0).astype(np.float64))
                if thr == tp_dist and (match >= 0).any():
                    ok = match >= 0
                    mb, mg = db[ok], gb[match[ok]]
                    ate = np.linalg.norm(mb[:, :2] - mg[:, :2], axis=-1)
                    # ASE: 1 - iou of size-aligned boxes
                    mins = np.minimum(mb[:, 3:6], mg[:, 3:6])
                    inter = np.prod(mins, -1)
                    union = (np.prod(mb[:, 3:6], -1)
                             + np.prod(mg[:, 3:6], -1) - inter)
                    ase = 1.0 - inter / np.maximum(union, 1e-8)
                    dyaw = mb[:, -1] - mg[:, -1]
                    aoe = np.abs((dyaw + np.pi) % (2 * np.pi) - np.pi)
                    if mb.shape[1] >= 9 and mg.shape[1] >= 9:
                        ave = np.linalg.norm(mb[:, 6:8] - mg[:, 6:8],
                                             axis=-1)
                    else:
                        ave = np.zeros_like(ate)
                    pooled[key]["tp_err"].append(
                        np.stack([ate, ase, aoe, ave], -1))
            pooled[key]["rows"].append(np.stack(row, -1))

    class_ap = {}
    tp_errs = []
    for ci, cname in enumerate(class_names):
        acc = pooled.get(ci)
        if acc is None or acc["n_gt"] == 0:
            continue
        rows = (np.concatenate(acc["rows"])
                if acc["rows"] else np.zeros((0, 1 + len(dist_thresholds))))
        aps = [_pr_from_matches(rows[:, 0], rows[:, 1 + k], acc["n_gt"])
               for k in range(len(dist_thresholds))]
        class_ap[cname] = float(np.mean(aps))
        if acc["tp_err"]:
            tp_errs.append(np.concatenate(acc["tp_err"]).mean(0))

    mean_ap = float(np.mean(list(class_ap.values()))) if class_ap else 0.0
    if tp_errs:
        errs = np.stack(tp_errs).mean(0)  # [ATE, ASE, AOE, AVE]
    else:
        errs = np.ones(4)
    # normalize AOE by pi (bounded), others already in natural units
    norm = np.array([1.0, 1.0, np.pi, 1.0])
    tp_scores = np.maximum(0.0, 1.0 - errs / norm)
    nds = float((5 * mean_ap + tp_scores.sum()) / (5 + len(tp_scores)))
    out = {f"AP/{k}": v for k, v in class_ap.items()}
    out.update({"mAP": mean_ap, "ATE": float(errs[0]), "ASE": float(errs[1]),
                "AOE": float(errs[2]), "AVE": float(errs[3]), "NDS": nds})
    return out


def gts_from_infos(infos, class_names):
    """Build the {token: {gt_boxes, gt_classes, num_points, difficulty}}
    dict from info pkls. num_points/difficulty (consumed by the official
    Waymo LEVEL_1/LEVEL_2 protocol, eval/waymo_protocol.py) default to
    -1 / 0 when the info lacks them."""
    gts = {}
    for info in infos:
        token = info.get("token", "")
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))))
        names = np.asarray(info.get("gt_names", []))
        n = len(boxes)
        npts = np.asarray(info.get("num_points_in_gt",
                                   -np.ones((n,), np.int64)), np.int64)
        diff = np.asarray(info.get("difficulty", np.zeros((n,), np.int64)),
                          np.int64)
        cls = np.array(
            [class_names.index(nm) if nm in class_names else -1
             for nm in names],
            np.int64)
        keep = cls >= 0
        gts[token] = {"gt_boxes": boxes[keep], "gt_classes": cls[keep],
                      "num_points": npts[keep] if len(npts) == n
                      else -np.ones((int(keep.sum()),), np.int64),
                      "difficulty": diff[keep] if len(diff) == n
                      else np.zeros((int(keep.sum()),), np.int64)}
    return gts
