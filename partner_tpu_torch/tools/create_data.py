"""Data preparation CLI of the port (counterpart of the Waymo half of
``tools/create_data.py``): the TFRecord converter, the info builder and
the GT-AUG database builder.

    python -m partner_tpu_torch.tools.create_data waymo_convert \\
        --record_path 'data/waymo/tfrecord_training/*.tfrecord' \\
        --root_path data/waymo --split train
    python -m partner_tpu_torch.tools.create_data waymo_data_prep \\
        --root_path data/waymo --split train [--nsweeps 1] [--max_sweeps 0]
    python -m partner_tpu_torch.tools.create_data create_groundtruth_database \\
        --root_path data/waymo --info_path <infos.pkl> [--used_classes ...]

Layouts, as the JAX tool writes and reads them:

- ``waymo_convert`` reads TFRecords (or pickled lists of fake frames) and
  writes ``<root>/<split>/lidar/seq_{s}_frame_{f}.pkl`` (``decode_frame``:
  ``lidars.points_xyz`` / ``points_feature``) and the same names under
  ``annos/`` (``decode_annos``: objects with ``box`` (9,), ``label``,
  ``num_points``, difficulties). The TFRecord framing is read in pure
  Python; only the proto parse needs the ``waymo_open_dataset`` package;
- ``waymo_data_prep`` writes ``<root>/infos_{split}_{nsweeps:02d}sweeps_
  filter_zero_gt.pkl``: per frame ``path``, ``anno_path``, ``token``,
  ``timestamp``, ``sweeps`` (up to ``max_sweeps`` earlier frames of the
  sequence, newest first; every earlier frame for 0, as the JAX tool
  slices them),
  ``gt_boxes`` (N, 9), ``gt_names``, ``difficulty`` and
  ``num_points_in_gt``; a train split drops frames with no box;
- ``create_groundtruth_database`` writes ``<root>/gt_database/
  {class}_{i}.bin`` (float32 rows, xyz shifted to the box center) and
  ``<root>/dbinfos_train.pkl`` ({class: [{name, path, box3d_lidar,
  num_points_in_gt, difficulty}]}), the boxes' points found by
  ``core.box_np_ops.points_in_rbbox`` (the native library where it is
  built).

``nuscenes_data_prep`` is not ported: the port has no ``NuScenesDataset``
to read its output (ROADMAP.md queue 1: nuScenes), and the subcommand
stops with that message, as a database of another dataset does.
"""

import argparse
import glob
import os
import pickle
import struct
import sys

import numpy as np

from ..core import box_np_ops
from ..data import waymo_decoder
from ..data.pipeline import get_obj, read_single_waymo

NOT_PORTED = ("create_data: only Waymo frames are read; the port has no "
              "NuScenesDataset (ROADMAP.md queue 1: nuScenes)")


def _object_name(o):
    """Class name of a decoded anno object: the converter's output carries
    the Waymo type int under ``label`` (``name`` is the tracking uuid);
    hand-built frames may carry the class string under ``name``."""
    name = o.get("name", "")
    if isinstance(name, str) and name in waymo_decoder.NAME_BY_TYPE.values():
        return name
    label = o.get("label")
    if isinstance(label, (int, np.integer)):
        return waymo_decoder.NAME_BY_TYPE.get(int(label), "UNKNOWN")
    return str(name)


def _read_tfrecord(path):
    """The raw records of a TFRecord file (8-byte little-endian length,
    4-byte masked crc, payload, 4-byte crc); the crcs are not checked."""
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            (length,) = struct.unpack("<Q", head)
            f.read(4)
            payload = f.read(length)
            f.read(4)
            yield payload


def waymo_convert(record_path, root_path, split="train"):
    """Waymo TFRecords (or pickled lists of fake frames) matching the glob
    ``record_path`` -> per-frame lidar and anno pkls under
    ``<root_path>/<split>/`` -> the lidar directory."""
    lidar_dir = os.path.join(root_path, split, "lidar")
    anno_dir = os.path.join(root_path, split, "annos")
    os.makedirs(lidar_dir, exist_ok=True)
    os.makedirs(anno_dir, exist_ok=True)
    fnames = sorted(glob.glob(record_path))
    if not fnames:
        raise FileNotFoundError(f"no records match {record_path!r}")
    n_frames = 0
    for seq_id, fname in enumerate(fnames):
        if fname.endswith(".pkl"):
            frames = get_obj(fname)
        else:
            from waymo_open_dataset import dataset_pb2  # the proto only

            frames = []
            for payload in _read_tfrecord(fname):
                fr = dataset_pb2.Frame()
                fr.ParseFromString(payload)
                frames.append(fr)
        for frame_id, frame in enumerate(frames):
            name = f"seq_{seq_id}_frame_{frame_id}.pkl"
            with open(os.path.join(lidar_dir, name), "wb") as f:
                pickle.dump(waymo_decoder.decode_frame(frame, frame_id), f)
            with open(os.path.join(anno_dir, name), "wb") as f:
                pickle.dump(waymo_decoder.decode_annos(frame, frame_id), f)
            n_frames += 1
    print(f"converted {n_frames} frames from {len(fnames)} records "
          f"-> {lidar_dir}")
    return lidar_dir


def waymo_data_prep(root_path, split="train", nsweeps=1, max_sweeps=0):
    """The info pkl of the converted frames under ``<root_path>/<split>/``
    (in file-name order) -> its path."""
    lidar_dir = os.path.join(root_path, split, "lidar")
    anno_dir = os.path.join(root_path, split, "annos")
    infos, prev_by_seq = [], {}
    for fname in sorted(os.listdir(lidar_dir)):
        path = os.path.join(lidar_dir, fname)
        anno_path = os.path.join(anno_dir, fname)
        token = os.path.splitext(fname)[0]
        seq = token.rsplit("_frame_", 1)[0] if "_frame_" in token else token
        info = {"path": path, "anno_path": anno_path, "token": token,
                "timestamp": len(infos), "sweeps": []}
        if os.path.exists(anno_path):
            objs = get_obj(anno_path).get("objects", [])
            info["gt_boxes"] = (
                np.stack([np.asarray(o["box"], np.float32) for o in objs])
                if objs else np.zeros((0, 9), np.float32))
            info["gt_names"] = np.asarray([_object_name(o) for o in objs])
            info["difficulty"] = np.asarray(
                [o.get("difficulty", o.get("detection_difficulty_level", 0))
                 for o in objs], np.int32)
            info["num_points_in_gt"] = np.asarray(
                [o.get("num_points", -1) for o in objs], np.int32)
        hist = prev_by_seq.setdefault(seq, [])
        # hist[-0:] is every earlier frame, as the JAX tool slices it
        for prev in hist[-max_sweeps:][::-1]:
            info["sweeps"].append({
                "path": prev["path"], "token": prev["token"],
                "transform_matrix": None,
                "time_lag": info["timestamp"] - prev["timestamp"]})
        hist.append(info)
        if (split == "train" and "gt_boxes" in info
                and not len(info["gt_boxes"])):
            continue   # filter_zero_gt
        infos.append(info)
    out = os.path.join(
        root_path, f"infos_{split}_{nsweeps:02d}sweeps_filter_zero_gt.pkl")
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {len(infos)} infos -> {out}")
    return out


def create_groundtruth_database(dataset, root_path, info_path,
                                used_classes=None, db_path=None,
                                dbinfo_path=None):
    """Crop every gt box's points of the infos at ``info_path`` into the
    GT-AUG database under ``root_path`` -> the dbinfos pkl's path. Only
    ``WaymoDataset`` frames are read; another dataset exits."""
    if dataset != "WaymoDataset":
        sys.exit(NOT_PORTED)
    db_path = db_path or os.path.join(root_path, "gt_database")
    dbinfo_path = dbinfo_path or os.path.join(root_path, "dbinfos_train.pkl")
    os.makedirs(db_path, exist_ok=True)
    db_infos, count = {}, 0
    for info in get_obj(info_path):
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                           np.float32)
        names = np.asarray(info.get("gt_names", []))
        if not len(boxes):
            continue
        points = read_single_waymo(get_obj(info["path"])).astype(np.float32)
        # box columns [x, y, z, dx, dy, dz, (vx, vy,) yaw]
        b7 = np.concatenate([boxes[:, :6], boxes[:, -1:]], axis=1)
        inside = box_np_ops.points_in_rbbox(points[:, :3], b7)
        difficulty = info.get("difficulty", [])
        for i, name in enumerate(names):
            if used_classes and name not in used_classes:
                continue
            obj_pts = points[inside[:, i]].copy()
            obj_pts[:, :3] -= b7[i, :3]
            rel = os.path.join("gt_database", f"{name}_{count}.bin")
            obj_pts.tofile(os.path.join(root_path, rel))
            db_infos.setdefault(str(name), []).append({
                "name": str(name),
                "path": rel,
                # the whole box (velocity kept), so sampled boxes
                # concatenate with the frame's own
                "box3d_lidar": boxes[i],
                "num_points_in_gt": int(inside[:, i].sum()),
                "difficulty": (int(difficulty[i]) if len(difficulty) > i
                               else 0),
            })
            count += 1
    with open(dbinfo_path, "wb") as f:
        pickle.dump(db_infos, f)
    n = sum(len(v) for v in db_infos.values())
    print(f"wrote {n} objects ({list(db_infos)}) -> {dbinfo_path}")
    return dbinfo_path


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Waymo data preparation: converter, infos, GT database")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("waymo_convert")
    c.add_argument("--record_path", required=True,
                   help="glob of TFRecord files (or fake-frame pkls)")
    c.add_argument("--root_path", required=True)
    c.add_argument("--split", default="train")
    w = sub.add_parser("waymo_data_prep")
    w.add_argument("--root_path", required=True)
    w.add_argument("--split", default="train")
    w.add_argument("--nsweeps", type=int, default=1)
    w.add_argument("--max_sweeps", type=int, default=0)
    sub.add_parser("nuscenes_data_prep", help="not ported")
    g = sub.add_parser("create_groundtruth_database")
    g.add_argument("--root_path", required=True)
    g.add_argument("--info_path", required=True)
    g.add_argument("--used_classes", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None):
    """Run one subcommand -> the path it wrote."""
    args = parse_args(argv)
    if args.cmd == "waymo_convert":
        return waymo_convert(args.record_path, args.root_path, args.split)
    if args.cmd == "waymo_data_prep":
        return waymo_data_prep(args.root_path, args.split, args.nsweeps,
                               args.max_sweeps)
    if args.cmd == "nuscenes_data_prep":
        sys.exit(NOT_PORTED)
    return create_groundtruth_database("WaymoDataset", args.root_path,
                                       args.info_path, args.used_classes)


if __name__ == "__main__":
    main()
