"""Data preparation CLI of the port (counterpart of ``tools/create_data.py``):
the Waymo TFRecord converter and info builder, the nuScenes info builder,
and the GT-AUG database builder of either.

    python -m partner_tpu_torch.tools.create_data waymo_convert \\
        --record_path 'data/waymo/tfrecord_training/*.tfrecord' \\
        --root_path data/waymo --split train
    python -m partner_tpu_torch.tools.create_data waymo_data_prep \\
        --root_path data/waymo --split train [--nsweeps 1] [--max_sweeps 0]
    python -m partner_tpu_torch.tools.create_data nuscenes_data_prep \\
        --root_path data/nuScenes [--version v1.0-trainval] [--nsweeps 10] \\
        [--frames_pkl <root>/frames.pkl]
    python -m partner_tpu_torch.tools.create_data create_groundtruth_database \\
        [--dataset WaymoDataset|NuScenesDataset] --root_path data/waymo \\
        --info_path <infos.pkl> [--used_classes ...]

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
- ``nuscenes_data_prep`` rewrites a pre-extracted frames pkl (a list of
  dicts with ``token``, ``lidar_path``, ``sweeps``, ``gt_boxes`` (N, 9),
  ``gt_names``, ``timestamp`` and the lidar -> ego -> global calibration)
  into ``<root>/infos_{train|val}_{nsweeps:02d}sweeps_withvelo_filter_
  True.pkl``. As in the JAX tool, an installed ``nuscenes`` devkit is not
  read: the subcommand then raises;
- ``create_groundtruth_database`` writes ``<root>/gt_database/
  {class}_{i}.bin`` (float32 rows, xyz shifted to the box center; a Waymo
  frame's five columns, a nuScenes key frame's four) and
  ``<root>/dbinfos_train.pkl`` ({class: [{name, path, box3d_lidar,
  num_points_in_gt, difficulty}]}), the boxes' points found by
  ``core.box_np_ops.points_in_rbbox`` (the native library where it is
  built).
"""

import argparse
import glob
import os
import pickle
import struct

import numpy as np

from ..core import box_np_ops
from ..data import waymo_decoder
from ..data.pipeline import get_obj, read_file, read_single_waymo


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


def nuscenes_data_prep(root_path, version="v1.0-trainval", nsweeps=10,
                       frames_pkl=None):
    """The nuScenes info pkl of the frames pkl ``frames_pkl``
    (``<root_path>/frames.pkl`` by default) -> its path; the split is
    ``train`` for a ``version`` naming it, else ``val``."""
    if frames_pkl is None:
        frames_pkl = os.path.join(root_path, "frames.pkl")
    try:
        from nuscenes import NuScenes  # noqa: F401
        have_devkit = True
    except ImportError:
        have_devkit = False
    if have_devkit:
        raise NotImplementedError(
            "the nuscenes devkit is installed, and reading the raw set "
            "through it is not wired (as in the JAX tool); infos come from "
            "a pre-extracted frames pkl")
    if not os.path.exists(frames_pkl):
        raise FileNotFoundError("nuscenes devkit unavailable and no "
                                f"pre-extracted frames pkl at {frames_pkl}")
    infos = []
    for fr in get_obj(frames_pkl):
        info = {
            "token": fr["token"],
            "lidar_path": fr["lidar_path"],
            "sweeps": fr.get("sweeps", []),
            "gt_boxes": np.asarray(fr.get("gt_boxes", np.zeros((0, 9)))),
            "gt_names": np.asarray(fr.get("gt_names", [])),
            "timestamp": fr.get("timestamp", 0),
        }
        # the calibration, for the results writer's global frame
        for k in ("lidar2ego_rotation", "lidar2ego_translation",
                  "ego2global_rotation", "ego2global_translation"):
            if k in fr:
                info[k] = fr[k]
        infos.append(info)
    split = "train" if "train" in version else "val"
    out = os.path.join(
        root_path,
        f"infos_{split}_{nsweeps:02d}sweeps_withvelo_filter_True.pkl")
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {len(infos)} infos -> {out}")
    return out


def _load_points(info, dataset):
    if dataset == "WaymoDataset":
        return read_single_waymo(get_obj(info["path"]))
    return read_file(str(info["lidar_path"]))


def create_groundtruth_database(dataset, root_path, info_path,
                                used_classes=None, db_path=None,
                                dbinfo_path=None):
    """Crop every gt box's points of the infos at ``info_path`` into the
    GT-AUG database under ``root_path`` -> the dbinfos pkl's path. A
    ``WaymoDataset`` info's points are its frame pickle's, any other
    dataset's its ``lidar_path`` ``.bin`` (the nuScenes key frame), as in
    the JAX tool."""
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
        points = _load_points(info, dataset).astype(np.float32)
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
        description="Data preparation: the Waymo converter and infos, the "
                    "nuScenes infos, the GT database")
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
    n = sub.add_parser("nuscenes_data_prep")
    n.add_argument("--root_path", required=True)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--nsweeps", type=int, default=10)
    n.add_argument("--frames_pkl", default=None)
    g = sub.add_parser("create_groundtruth_database")
    g.add_argument("--dataset", default="WaymoDataset")
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
        return nuscenes_data_prep(args.root_path, args.version, args.nsweeps,
                                  args.frames_pkl)
    return create_groundtruth_database(args.dataset, args.root_path,
                                       args.info_path, args.used_classes)


if __name__ == "__main__":
    main()
