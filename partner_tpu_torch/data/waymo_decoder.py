"""Waymo Open Dataset range-image decoder, pure numpy and TF-free
(the port's copy of ``partner_tpu/data/waymo_decoder.py``, which it may not
import: the port reuses no module of the JAX package).

It decodes as the reference's TensorFlow pipeline does
(``range_image_utils.extract_point_cloud_from_range_image``):

- beam inclinations: the calibration's list (row-reversed so row 0 is the
  top beam), or uniform spacing between ``inclination_min`` and
  ``inclination_max`` (``compute_inclination``);
- per-column azimuth: ((W - j - 0.5) / W * 2 - 1) * pi minus the
  extrinsic's yaw (``compute_range_image_polar``);
- polar -> cartesian in the sensor frame, then the sensor -> vehicle
  extrinsic;
- the TOP lidar's rolling-shutter correction: a vehicle -> global pose per
  pixel, then the inverse frame pose back into the reference vehicle
  frame (``compute_range_image_cartesian``'s pixel_pose / frame_pose path).

``decode_frame`` and ``decode_annos`` take either real ``dataset_pb2.Frame``
protos (attribute duck-typing) or plain dict / namespace fakes that carry
numpy range images. Only a real proto's zlib ``MatrixFloat`` payloads need
the ``waymo_open_dataset`` package, imported inside ``_laser_points`` when
one is met. The output pkl layout is what the data pipeline reads
(``data.pipeline.read_single_waymo``: ``{"lidars": {"points_xyz",
"points_feature"}}``).
"""

import numpy as np

# waymo label_pb2.Label.Type enum order
TYPE_LIST = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")
NAME_BY_TYPE = {1: "Vehicle", 2: "Pedestrian", 3: "Sign", 4: "Cyclist"}


def compute_inclination(inclination_min, inclination_max, height):
    """Uniform beam inclinations at row centers (range_image_utils
    compute_inclination): ascending, caller reverses for row order."""
    return ((0.5 + np.arange(height)) / height
            * (inclination_max - inclination_min) + inclination_min)


def range_image_polar(height, width, extrinsic, inclinations):
    """(incl (H,), az (W,)) grids for a range image.

    inclinations: (H,) already in ROW order (row 0 = top beam).
    azimuth: column 0 is +pi (sweep is right-to-left), minus the
    extrinsic yaw so azimuth 0 faces the vehicle's +x.
    """
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (width - np.arange(width) - 0.5) / width
    azimuth = (ratios * 2.0 - 1.0) * np.pi - az_correction
    return np.asarray(inclinations, np.float64), azimuth


def range_image_to_cartesian(range_image, extrinsic, inclinations,
                             pixel_pose=None, frame_pose=None):
    """Range channel (H, W) -> vehicle-frame xyz (H, W, 3).

    extrinsic: (4, 4) sensor->vehicle. pixel_pose: optional (H, W, 4, 4)
    vehicle->global per pixel (TOP lidar rolling shutter); frame_pose:
    (4, 4) vehicle->global at the frame timestamp.
    """
    r = np.asarray(range_image, np.float64)
    h, w = r.shape
    incl, az = range_image_polar(h, w, extrinsic, inclinations)
    cos_i, sin_i = np.cos(incl)[:, None], np.sin(incl)[:, None]
    cos_a, sin_a = np.cos(az)[None, :], np.sin(az)[None, :]
    x = cos_a * cos_i * r
    y = sin_a * cos_i * r
    z = sin_i * r
    pts = np.stack([x, y, z], axis=-1)  # sensor frame

    rot, t = extrinsic[:3, :3], extrinsic[:3, 3]
    pts = pts @ rot.T + t  # vehicle frame

    if pixel_pose is not None:
        pp = np.asarray(pixel_pose, np.float64)
        pts = np.einsum("hwij,hwj->hwi", pp[..., :3, :3], pts) + pp[..., :3, 3]
        inv = np.linalg.inv(np.asarray(frame_pose, np.float64))
        pts = pts @ inv[:3, :3].T + inv[:3, 3]
    return pts


def decode_range_image(range_image, extrinsic, inclinations,
                       pixel_pose=None, frame_pose=None):
    """One return: (N, 6) valid points [x, y, z, intensity, elongation,
    nlz]. range_image: (H, W, >=4) channels [range, intensity, elongation,
    is_in_nlz]."""
    ri = np.asarray(range_image, np.float64)
    mask = ri[..., 0] > 0
    xyz = range_image_to_cartesian(ri[..., 0], extrinsic, inclinations,
                                   pixel_pose, frame_pose)
    return np.concatenate([xyz[mask], ri[mask][:, 1:4]], axis=1)


# ---------------------------------------------------------------------------
# frame-level decoding (duck-typed: waymo protos or dict fakes)
# ---------------------------------------------------------------------------


def _get(obj, key, default=None):
    if isinstance(obj, dict):
        return obj.get(key, default)
    return getattr(obj, key, default)


def _laser_points(laser, calibration, frame_pose_mat):
    """Both returns of one laser -> (N, 6) numpy (mirrors
    extract_points_from_range_image; waymo_decoder.py:71-138)."""
    import zlib

    def parse_matrix(compressed, shape_hint=None):
        # real protos carry zlib MatrixFloat; fakes carry numpy directly
        if isinstance(compressed, np.ndarray):
            return compressed
        from waymo_open_dataset import dataset_pb2

        m = dataset_pb2.MatrixFloat.FromString(zlib.decompress(compressed))
        return np.array(m.data, np.float64).reshape(m.shape.dims)

    incl_list = list(_get(calibration, "beam_inclinations", []) or [])
    extrinsic = np.reshape(
        np.asarray(list(_get(_get(calibration, "extrinsic"), "transform")),
                   np.float64), (4, 4))

    is_top = _get(laser, "name") == 1  # dataset_pb2.LaserName.TOP
    pixel_pose = frame_pose = None
    ri1 = _get(laser, "ri_return1")
    if is_top and _get(ri1, "range_image_pose_compressed", None) is not None:
        pose_ri = parse_matrix(_get(ri1, "range_image_pose_compressed"))
        # (H, W, 6): rotation rpy + translation xyz -> (H, W, 4, 4)
        roll, pitch, yaw = pose_ri[..., 0], pose_ri[..., 1], pose_ri[..., 2]
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        rot = np.stack([
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ], axis=-1).reshape(pose_ri.shape[:2] + (3, 3))
        pixel_pose = np.zeros(pose_ri.shape[:2] + (4, 4))
        pixel_pose[..., :3, :3] = rot
        pixel_pose[..., :3, 3] = pose_ri[..., 3:6]
        pixel_pose[..., 3, 3] = 1.0
        frame_pose = frame_pose_mat

    points = []
    for ret_name in ("ri_return1", "ri_return2"):
        ret = _get(laser, ret_name)
        if ret is None:
            continue
        ri = parse_matrix(_get(ret, "range_image_compressed")
                          if not isinstance(_get(ret, "range_image"),
                                            np.ndarray)
                          else _get(ret, "range_image"))
        if not incl_list:
            incl = compute_inclination(
                float(_get(calibration, "beam_inclination_min")),
                float(_get(calibration, "beam_inclination_max")),
                ri.shape[0])
        else:
            incl = np.asarray(incl_list, np.float64)
        incl = incl[::-1]  # row 0 = top beam
        points.append(decode_range_image(ri, extrinsic, incl,
                                         pixel_pose, frame_pose))
    return np.concatenate(points, axis=0) if points else np.zeros((0, 6))


def extract_points(lasers, calibrations, frame_pose_mat):
    """All lasers -> {"points_xyz", "points_feature"} (intensity,
    elongation); NLZ points are dropped like the reference consumer."""
    by_name = {_get(c, "name"): c for c in calibrations}
    xyz, feat = [], []
    for laser in sorted(lasers, key=lambda l: _get(l, "name")):
        pts = _laser_points(laser, by_name[_get(laser, "name")],
                            frame_pose_mat)
        keep = pts[:, 5] <= 0  # drop no-label-zone points
        xyz.append(pts[keep, :3])
        feat.append(pts[keep, 3:5])
    return {
        "points_xyz": np.concatenate(xyz).astype(np.float32),
        "points_feature": np.concatenate(feat).astype(np.float32),
    }


def global_vel_to_ref(vel, ref_rotation):
    """Global-frame velocity into the reference vehicle frame."""
    v = np.array([vel[0], vel[1], 0.0])
    ref = ref_rotation.T @ v
    return [float(ref[0]), float(ref[1]), 0.0]


def extract_objects(laser_labels, ref_rotation):
    """Labels -> object dicts with the combined difficulty (intended
    semantics of waymo_decoder.py:174-185; see also
    eval/waymo_protocol.combined_difficulty)."""
    objects = []
    for object_id, label in enumerate(laser_labels):
        box = _get(label, "box")
        meta = _get(label, "metadata", {})
        speed = [float(_get(meta, "speed_x", 0.0) or 0.0),
                 float(_get(meta, "speed_y", 0.0) or 0.0)]
        accel = [float(_get(meta, "accel_x", 0.0) or 0.0),
                 float(_get(meta, "accel_y", 0.0) or 0.0)]
        num_points = int(_get(label, "num_lidar_points_in_box", 0) or 0)
        labeler = int(_get(label, "detection_difficulty_level", 0) or 0)
        if num_points <= 0:
            combined = 999
        elif labeler != 0:
            combined = labeler
        else:
            combined = 1 if num_points >= 5 else 2
        ref_vel = global_vel_to_ref(speed, ref_rotation)
        objects.append({
            "id": object_id,
            "name": _get(label, "id"),
            "label": int(_get(label, "type", 0) or 0),
            "box": np.array([
                float(_get(box, "center_x")), float(_get(box, "center_y")),
                float(_get(box, "center_z")), float(_get(box, "length")),
                float(_get(box, "width")), float(_get(box, "height")),
                ref_vel[0], ref_vel[1], float(_get(box, "heading")),
            ], np.float32),
            "num_points": num_points,
            "detection_difficulty_level": labeler,
            "combined_difficulty_level": combined,
            "global_speed": np.array(speed, np.float32),
            "global_accel": np.array(accel, np.float32),
        })
    return objects


def _frame_name(frame):
    ctx = _get(frame, "context")
    stats = _get(ctx, "stats", {})
    return "{}_{}_{}_{}".format(
        _get(ctx, "name"), _get(stats, "location", ""),
        _get(stats, "time_of_day", ""), _get(frame, "timestamp_micros"))


def decode_frame(frame, frame_id):
    """Frame proto/fake -> lidar pkl payload (waymo_decoder.py:22-43)."""
    pose = np.reshape(
        np.asarray(list(_get(_get(frame, "pose"), "transform")), np.float64),
        (4, 4))
    lidars = extract_points(_get(frame, "lasers"),
                            _get(_get(frame, "context"),
                                 "laser_calibrations"),
                            pose)
    return {
        "scene_name": _get(_get(frame, "context"), "name"),
        "frame_name": _frame_name(frame),
        "frame_id": frame_id,
        "lidars": lidars,
    }


def decode_annos(frame, frame_id):
    """Frame proto/fake -> anno pkl payload (waymo_decoder.py:45-69)."""
    veh_to_global = np.asarray(list(_get(_get(frame, "pose"), "transform")),
                               np.float64)
    ref_pose = np.reshape(veh_to_global, (4, 4))
    objects = extract_objects(_get(frame, "laser_labels", []) or [],
                              ref_pose[:3, :3])
    return {
        "scene_name": _get(_get(frame, "context"), "name"),
        "frame_name": _frame_name(frame),
        "frame_id": frame_id,
        "veh_to_global": veh_to_global,
        "objects": objects,
    }
