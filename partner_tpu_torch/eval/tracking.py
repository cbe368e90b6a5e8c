"""Greedy velocity tracker (CenterPoint-style), Waymo + nuScenes variants.

A copy of ``partner_tpu/eval/tracking.py``: the port imports nothing of the
JAX package, not even its numpy-only modules. Host numpy in both packages:
detections are back-projected by velocity * time_lag and greedily matched
to live tracks by center distance with per-class gates; unmatched
detections above the score threshold open new tracks; unmatched tracks
persist ``max_age`` frames (the reference's waymo_tracking/tracker.py and
nusc_tracking/pub_tracker.py).

One change against the JAX module: :func:`convert_detection_to_global_box`
takes each frame's pose from :func:`frame_pose`, which reads an info's
``pose`` as JAX does, and otherwise the pose the infos of either
``create_data`` do carry (Waymo's ``veh_to_global`` in the anno pickle,
nuScenes' lidar -> ego -> global records). JAX falls back to the identity
there, so it tracks in the moving sensor frame.
"""

import numpy as np

from .nuscenes import CALIB_CHAIN, has_calibration, lidar_to_global

WAYMO_TRACKING_NAMES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]

NUSC_TRACKING_NAMES = [
    "bicycle", "bus", "car", "motorcycle", "pedestrian", "trailer", "truck",
]

# nuScenes per-class center-distance gates (m), CenterPoint defaults
NUSC_CLS_VELOCITY_ERROR = {
    "car": 4, "truck": 4, "bus": 5.5, "trailer": 3, "pedestrian": 1,
    "motorcycle": 13, "bicycle": 3,
}


def greedy_assignment(dist):
    """Row-greedy nearest matching (tracker.py:9-18)."""
    matched = []
    if dist.shape[1] == 0:
        return np.zeros((0, 2), np.int32)
    dist = dist.copy()
    for i in range(dist.shape[0]):
        j = dist[i].argmin()
        if dist[i][j] < 1e16:
            dist[:, j] = 1e18
            matched.append([i, j])
    return np.asarray(matched, np.int32).reshape(-1, 2)


class GreedyTracker:
    def __init__(self, tracking_names, max_dist, max_age=3, score_thresh=0.1):
        self.tracking_names = list(tracking_names)
        self.max_dist = dict(max_dist)
        self.max_age = max_age
        self.score_thresh = score_thresh
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks = []

    def step(self, results, time_lag):
        """results: list of dicts with keys translation (3,), velocity (2,),
        detection_name, score. Returns active tracks for this frame."""
        dets_in = []
        for det in results:
            if det["detection_name"] not in self.tracking_names:
                continue
            d = dict(det)
            d["ct"] = np.asarray(det["translation"][:2], np.float32)
            d["tracking"] = (
                -np.asarray(det.get("velocity", (0, 0))[:2], np.float32)
                * time_lag
            )
            d["label_preds"] = self.tracking_names.index(
                det["detection_name"]
            )
            dets_in.append(d)
        results = dets_in
        if not results:
            # age out all tracks
            self.tracks = [
                t for t in self.tracks if t["age"] < self.max_age
            ]
            for t in self.tracks:
                t["age"] += 1
                t["active"] = 0
            return []

        n = len(results)
        m = len(self.tracks)
        dets = np.stack([d["ct"] + d["tracking"] for d in results])
        item_cat = np.array([d["label_preds"] for d in results])
        track_cat = np.array([t["label_preds"] for t in self.tracks]
                             ).reshape(1, -1)
        max_diff = np.array(
            [self.max_dist[d["detection_name"]] for d in results], np.float32
        )

        if m:
            centers = np.stack([t["ct"] for t in self.tracks])
            dist = np.linalg.norm(
                centers[None] - dets[:, None], axis=2
            )  # (N, M)
            invalid = (dist > max_diff[:, None]) | (
                item_cat[:, None] != track_cat
            )
            dist = dist + invalid * 1e18
            matched = greedy_assignment(dist)
        else:
            matched = np.zeros((0, 2), np.int32)

        unmatched_dets = [d for d in range(n) if d not in matched[:, 0]]
        unmatched_tracks = [t for t in range(m) if t not in matched[:, 1]]

        ret = []
        for i, j in matched:
            track = results[i]
            track["tracking_id"] = self.tracks[j]["tracking_id"]
            track["age"] = 1
            track["active"] = self.tracks[j]["active"] + 1
            ret.append(track)
        for i in unmatched_dets:
            track = results[i]
            if track["score"] > self.score_thresh:
                self.id_count += 1
                track["tracking_id"] = self.id_count
                track["age"] = 1
                track["active"] = 1
                ret.append(track)
        for i in unmatched_tracks:
            track = self.tracks[i]
            if track["age"] < self.max_age:
                track["age"] += 1
                track["active"] = 0
                # coast: advance by the (negated) back-projection
                track["ct"] = track["ct"] - track["tracking"]
                ret.append(track)
        self.tracks = ret
        return [t for t in ret if t["active"] > 0]


def waymo_tracker(max_age=3, score_thresh=0.75,
                  max_dist=None):
    return GreedyTracker(
        WAYMO_TRACKING_NAMES,
        max_dist or {"VEHICLE": 2.5, "PEDESTRIAN": 1.0, "CYCLIST": 1.5},
        max_age=max_age, score_thresh=score_thresh,
    )


def nusc_tracker(max_age=3, score_thresh=0.1, max_dist=None):
    return GreedyTracker(
        NUSC_TRACKING_NAMES, max_dist or NUSC_CLS_VELOCITY_ERROR,
        max_age=max_age, score_thresh=score_thresh,
    )


def frame_pose(info):
    """The 4 x 4 lidar -> global pose of a frame: the info's ``pose`` where
    it has one (as the JAX package reads it); else Waymo's
    ``veh_to_global`` from the anno pickle its ``anno_path`` names (the
    vehicle frame is the Waymo points' frame); else the nuScenes
    lidar -> ego -> global chain of its calibration records, through the
    results writer's rotations (``eval.nuscenes.lidar_to_global``).
    Raises KeyError naming ``pose`` where the info has none of them."""
    if "pose" in info:
        return np.asarray(info["pose"])
    if "anno_path" in info:
        from ..data.pipeline import get_obj

        anno = get_obj(info["anno_path"])
        if "veh_to_global" in anno:
            return np.reshape(np.asarray(anno["veh_to_global"], np.float64),
                              (4, 4))
    if has_calibration(info):
        return lidar_to_global(info)
    raise KeyError(
        f"frame {info.get('token')!r}: its info has no 'pose', no "
        "'anno_path' to an anno with 'veh_to_global', and no nuScenes "
        f"calibration {[k for pair in CALIB_CHAIN for k in pair]}")


def convert_detection_to_global_box(detections, infos):
    """Lidar-frame detections -> global frame via per-frame pose
    (waymo_tracking/test.py:212-255 semantics; the pose by
    :func:`frame_pose`); returns per-frame dicts ordered by timestamp."""
    frames = []
    infos_by_token = {i["token"]: i for i in infos}
    for token, det in detections.items():
        info = infos_by_token[token]
        pose = frame_pose(info)
        boxes = np.asarray(det["box3d_lidar"])
        if boxes.size:
            centers = boxes[:, :3]
            hom = np.concatenate(
                [centers, np.ones((len(centers), 1))], axis=1
            )
            centers_g = (pose @ hom.T).T[:, :3]
            vel = boxes[:, 6:8] if boxes.shape[1] > 7 else np.zeros(
                (len(boxes), 2)
            )
            vel_g = vel @ pose[:2, :2].T
        else:
            centers_g = np.zeros((0, 3))
            vel_g = np.zeros((0, 2))
        frames.append({
            "token": token,
            "timestamp": info.get("timestamp", 0),
            "global_boxes": centers_g,
            "velocity": vel_g,
            "scores": np.asarray(det["scores"]),
            "label_preds": np.asarray(det["label_preds"]),
        })
    frames.sort(key=lambda f: f["timestamp"])
    return frames


def mota_evaluate(results, gt_frames, max_match_dist=2.0):
    """Local CLEAR-MOT tracking metrics (MOTA + components).

    The reference scores tracking with the external Waymo devkit
    (waymo_tracking/test.py writes a bin for it); this in-framework
    evaluator implements the standard CLEAR-MOT counting — greedy
    center-distance matching per frame/class, misses + false positives +
    identity switches over GT — so the line-search tool
    (tools/track_line_search.py) can optimize gates without the devkit.

    Args:
      results: {token: {tracking_ids, boxes_global (N,3), labels}} — the
        run_tracking output.
      gt_frames: {token: {centers (M,2|3), labels (M,), ids (M,)}} in the
        same global frame, frames in temporal order of dict insertion.
      max_match_dist: association gate in meters (BEV center distance).

    Returns dict(mota, misses, false_positives, id_switches, num_gt).
    """
    misses = fps = idsw = n_gt = 0
    last_id = {}  # gt id -> tracker id matched last time
    for token, gt in gt_frames.items():
        garr = np.asarray(gt["centers"], np.float32)
        g_xy = (garr.reshape(-1, garr.shape[-1])[:, :2] if garr.size
                else np.zeros((0, 2), np.float32))
        g_lab = np.asarray(gt["labels"]).reshape(-1)
        g_ids = np.asarray(gt["ids"]).reshape(-1)
        n_gt += len(g_xy)
        r = results.get(token)
        if r is None or len(r["tracking_ids"]) == 0:
            misses += len(g_xy)
            continue
        t_xy = np.asarray(r["boxes_global"], np.float32)[:, :2]
        t_lab = np.asarray(r["labels"])
        t_ids = np.asarray(r["tracking_ids"])

        dist = np.linalg.norm(g_xy[:, None] - t_xy[None, :], axis=-1)
        dist = np.where(g_lab[:, None] == t_lab[None, :], dist, 1e18)
        dist = np.where(dist <= max_match_dist, dist, 1e18)
        matched_t = set()
        matched_g = set()
        # CLEAR-MOT: persist still-valid previous-frame correspondences
        # FIRST — only unmatched objects go through fresh greedy matching.
        # Without this, two nearby same-class objects can swap pairings
        # frame-to-frame and count spurious id switches.
        tid_col = {int(t): j for j, t in enumerate(t_ids)}
        for gi in range(len(g_xy)):
            gid = int(g_ids[gi])
            prev = last_id.get(gid)
            if prev is None or prev not in tid_col:
                continue
            ti = tid_col[prev]
            if ti not in matched_t and dist[gi, ti] < 1e16:
                matched_g.add(gi)
                matched_t.add(ti)
        sub = dist.copy()
        for gi in matched_g:
            sub[gi, :] = 1e18
        for ti in matched_t:
            sub[:, ti] = 1e18
        for gi, ti in greedy_assignment(sub):
            matched_g.add(gi)
            matched_t.add(ti)
            gid = int(g_ids[gi])
            tid = int(t_ids[ti])
            if gid in last_id and last_id[gid] != tid:
                idsw += 1
            last_id[gid] = tid
        misses += len(g_xy) - len(matched_g)
        fps += len(t_xy) - len(matched_t)
    mota = 1.0 - (misses + fps + idsw) / max(n_gt, 1)
    return {"mota": mota, "misses": misses, "false_positives": fps,
            "id_switches": idsw, "num_gt": n_gt}
