"""Waymo evaluation output writer.

A copy of ``partner_tpu/eval/waymo.py``: the port imports nothing of
the JAX package, not even its numpy-only modules.

Serializes detections into the waymo-open-dataset ``objects.bin`` protobuf
layout consumed by the external devkit metrics tool, mirroring
the reference's det3d/datasets/waymo/waymo_common.py:52-115 including the
det3d -> Waymo coordinate transform (length/width swap and
heading = -yaw - pi/2, waymo_common.py:69-72). The bytes are produced by
the devkit protos when installed, else by the hand-rolled encoder in
``waymo_proto`` (byte-identical by construction — golden-validated against
a protoc-compiled schema twin in tests/test_waymo_writer.py), so the proto
path runs everywhere.
"""

import os
import uuid

import numpy as np

from . import waymo_proto

LABEL_TO_TYPE = {0: 1, 1: 2, 2: 4}  # Vehicle, Pedestrian, Cyclist


class _UUIDGeneration:
    """Stable uuid per tracking id (waymo_common.py:42-49)."""

    def __init__(self):
        self.mapping = {}

    def get_uuid(self, seed):
        if seed not in self.mapping:
            self.mapping[seed] = uuid.uuid4().hex
        return self.mapping[seed]


def _to_waymo_frame(box3d):
    """det3d boxes [x, y, z, dx, dy, dz, yaw] -> Waymo [x, y, z, length,
    width, height, heading]: dims swapped and heading = -yaw - pi/2
    (waymo_common.py:68-72)."""
    box3d = np.array(box3d, dtype=np.float64, copy=True)
    box3d[:, -1] = -box3d[:, -1] - np.pi / 2
    return box3d[:, [0, 1, 2, 4, 3, 5, -1]]


def _frame_fields(info):
    """(context_name, frame_timestamp_micros) from an info dict; accepts
    both the decoder's layout and the reference anno layout."""
    anno = info.get("anno", {}) or {}
    context = anno.get("scene_name", info.get("context", ""))
    frame = anno.get("frame_name", info.get("frame_name", None))
    if frame is not None and "_" in str(frame):
        ts = int(str(frame).split("_")[-1])
    else:
        ts = int(anno.get("frame_id", info.get("frame_id", 0)))
    return context, ts


def create_pd_detection(detections, infos, result_path, tracking=False):
    os.makedirs(result_path or ".", exist_ok=True)
    infos_by_token = {i["token"]: i for i in infos}
    uuid_gen = _UUIDGeneration()

    try:
        from waymo_open_dataset import label_pb2  # noqa: F401
        from waymo_open_dataset.protos import metrics_pb2
        have_devkit = True
        objects = metrics_pb2.Objects()
    except ImportError:
        have_devkit = False
        objects = []

    for token, det in detections.items():
        info = infos_by_token[token]
        context, ts = _frame_fields(info)
        box3d = _to_waymo_frame(np.asarray(det["box3d_lidar"]))
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        track_ids = det.get("tracking_ids") if tracking else None
        for i in range(box3d.shape[0]):
            obj_type = LABEL_TO_TYPE.get(int(labels[i]), 1)
            obj_id = (uuid_gen.get_uuid(int(track_ids[i]))
                      if track_ids is not None else None)
            if have_devkit:
                o = metrics_pb2.Object()
                o.context_name = context
                o.frame_timestamp_micros = ts
                b = o.object.box
                (b.center_x, b.center_y, b.center_z, b.length, b.width,
                 b.height, b.heading) = box3d[i]
                o.object.type = obj_type
                if obj_id is not None:
                    o.object.id = obj_id
                o.score = float(scores[i])
                objects.objects.append(o)
            else:
                label = waymo_proto.encode_label(
                    waymo_proto.encode_box(*box3d[i]), obj_type, obj_id)
                objects.append(waymo_proto.encode_object(
                    label, float(scores[i]), context, ts))

    name = "tracking_pred.bin" if tracking else "detection_pred.bin"
    out = os.path.join(result_path or ".", name)
    payload = (objects.SerializeToString() if have_devkit
               else waymo_proto.encode_objects(objects))
    with open(out, "wb") as f:
        f.write(payload)
    return out
