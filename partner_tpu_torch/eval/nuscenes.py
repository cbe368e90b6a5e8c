"""nuScenes result writer: detections -> devkit-format results json.

A copy of ``partner_tpu/eval/nuscenes.py``: the port imports nothing of
the JAX package, not even its numpy-only modules.

Reconstructed from the PolarStream/CenterPoint lineage the missing
NuScenesDataset.evaluation relied on (the reference repo ships configs
for nusc but not the dataset/eval code — see SURVEY.md §2.3): the
submission schema is the devkit's `submission` / `sample_result` spec —
meta with the five use_* booleans, and per-box entries with exactly
{sample_token, translation, size, rotation, velocity, detection_name,
detection_score, attribute_name}.

Boxes are converted from the lidar frame to the global frame through the
info's calibration records when present (lidar->ego via
lidar2ego_{rotation,translation}, ego->global via
ego2global_{rotation,translation} — the CenterPoint
`lidar_nusc_box_to_global` chain: rotate, translate, rotate, translate,
with velocity rotated only). Without calibration the lidar-frame boxes
are written directly (synthetic/test mode). Schema + transform goldens:
tests/test_nusc_writer.py (the JAX module), tests/test_torch_nusc_eval.py
(this copy against it).
"""

import json
import os

import numpy as np

DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}

# the devkit's submission meta — all five keys are required
NUSC_META = {
    "use_camera": False,
    "use_lidar": True,
    "use_radar": False,
    "use_map": False,
    "use_external": False,
}


def _yaw_to_quaternion(yaw):
    return np.array(
        [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float64)


def _quat_mult(a, b):
    """Hamilton product of [w, x, y, z] quaternions."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], np.float64)


def _quat_rotate(q, v):
    """Rotate 3-vector v by quaternion q = [w, x, y, z]."""
    w, x, y, z = q
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)
    return r @ np.asarray(v, np.float64)


# the info's lidar -> ego and ego -> global records, (rotation, translation)
CALIB_CHAIN = (("lidar2ego_rotation", "lidar2ego_translation"),
               ("ego2global_rotation", "ego2global_translation"))


def has_calibration(info):
    return all(k in info for pair in CALIB_CHAIN for k in pair)


def _box_to_global(center, q_box, vel, info):
    """lidar -> ego -> global (CenterPoint lidar_nusc_box_to_global)."""
    for rot_key, tr_key in CALIB_CHAIN:
        q = np.asarray(info[rot_key], np.float64)
        t = np.asarray(info[tr_key], np.float64)
        center = _quat_rotate(q, center) + t
        q_box = _quat_mult(q, q_box)
        vel = _quat_rotate(q, vel)
    return center, q_box, vel


def lidar_to_global(info):
    """The 4 x 4 lidar -> global matrix of :func:`_box_to_global`'s chain
    (float64): each record's rotation by :func:`_quat_rotate` of the unit
    axes, then its translation."""
    pose = np.eye(4)
    for rot_key, tr_key in CALIB_CHAIN:
        q = np.asarray(info[rot_key], np.float64)
        step = np.eye(4)
        step[:3, :3] = np.stack([_quat_rotate(q, e) for e in np.eye(3)], 1)
        step[:3, 3] = np.asarray(info[tr_key], np.float64)
        pose = step @ pose
    return pose


def write_nusc_results(detections, infos, output_dir, class_names):
    os.makedirs(output_dir or ".", exist_ok=True)
    info_by_token = {}
    for info in infos or []:
        tok = info.get("token") if isinstance(info, dict) else None
        if tok is not None:
            info_by_token[tok] = info

    results = {}
    for token, det in detections.items():
        boxes = np.asarray(det["box3d_lidar"])
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        info = info_by_token.get(token, {})
        has_calib = has_calibration(info)
        annos = []
        for i in range(boxes.shape[0]):
            name = class_names[int(labels[i])]
            center = boxes[i, :3].astype(np.float64)
            q_box = _yaw_to_quaternion(float(boxes[i, -1]))
            vel2 = (boxes[i, 6:8] if boxes.shape[1] > 7
                    else np.zeros(2, np.float64))
            vel = np.array([vel2[0], vel2[1], 0.0], np.float64)
            if has_calib:
                center, q_box, vel = _box_to_global(
                    center, q_box, vel, info)
            annos.append({
                "sample_token": token,
                "translation": center.tolist(),
                "size": boxes[i, 3:6].tolist(),
                "rotation": q_box.tolist(),
                "velocity": vel[:2].tolist(),
                "detection_name": name,
                "detection_score": float(scores[i]),
                "attribute_name": DEFAULT_ATTRIBUTES.get(name, ""),
            })
        results[token] = annos
    out = os.path.join(output_dir or ".", "results_nusc.json")
    with open(out, "w") as f:
        json.dump({"meta": dict(NUSC_META), "results": results}, f)
    return out
