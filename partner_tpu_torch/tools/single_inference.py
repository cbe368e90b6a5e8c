"""Online single-sweep inference of the port (counterpart of
``tools/single_inference.py``).

    python -m partner_tpu_torch.tools.single_inference CONFIG
        [--watch_dir D] [--once] [--checkpoint CKPT] [--score 0.3]
        [--max_points P] [--poll S] [--device cuda|cpu]
        [--ros --topic T --out_topic T]

Per frame, as the reference's node does: cartesian points -> the config's
point layout (``transform_points``) -> a padded buffer of ``--max_points``
rows -> voxels on the device (``ops.voxelize.dynamic_voxelize``, up to
``max_voxel_num`` voxels, its first entry where it is a list) -> the
detector's ``predict`` through its voxel path -> the kept boxes at or
above ``--score``.

The transport: with ``--ros`` and ``rospy`` importable, it subscribes to
``--topic`` (sensor_msgs/PointCloud2) and publishes the boxes on
``--out_topic``; otherwise it watches ``--watch_dir`` for ``.bin`` /
``.npy`` point files, takes each once, and writes ``<frame>.det.npz``
beside it (``--once``: the files there now, then exit).

Runs on the card unless ``--device cpu``; with no card it stops with an
error. ``--checkpoint`` reads a port or a JAX checkpoint
(``train/checkpoint.py:load_checkpoint``); without one the weights come
from a seeded ``torch.Generator`` (seed 0).
"""

import argparse
import os
import sys
import time

import numpy as np
import torch


def build_predictor(cfg, checkpoint=None, max_points=200000, device="cuda",
                    seed=0):
    """(detector, predict, meta) for single-frame inference on ``device``:
    ``predict(points, points_mask)`` takes a (P, C) buffer and its mask as
    tensors on the device and returns the detector's outputs (batch 1)."""
    from ..models import build_detector
    from ..ops.voxelize import DeviceVoxelizer
    from ..train.checkpoint import load_checkpoint

    det = build_detector(cfg["model"], cfg.get("train_cfg"),
                         cfg.get("test_cfg"), device=device,
                         generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        payload, _ = load_checkpoint(checkpoint)
        det.module.load_state_dict(payload["state_dict"], strict=True)
    vg = dict(cfg["voxel_generator"])
    mv = vg.get("max_voxel_num", 150000)
    voxelize = DeviceVoxelizer(vg, device,
                               mv if isinstance(mv, int) else mv[0])

    def predict(points, pmask):
        return det.predict(voxelize(points[None], pmask[None]))

    # a two-stage config's reader is its first stage's
    reader = dict(cfg["model"].get("first_stage_cfg", cfg["model"]))[
        "reader"]
    meta = dict(n_feat=reader.get("num_input_features", 7),
                max_points=max_points, device=torch.device(device),
                voxel_shape=vg.get("voxel_shape", "cylinder"))
    return det, predict, meta


def sync_device(device):
    """Wait for ``device``'s work where it is a card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_frame(predict, meta, cart_points, score_threshold=0.3):
    """One frame: cartesian points (N, >=3 [+ features]) -> the kept boxes
    at or above ``score_threshold`` (numpy) and ``time``, the seconds from
    the buffer's copy to the device to the outputs back on the host."""
    from ..core import box_np_ops

    # transform the whole feature array so the extras land in the layout's
    # slots (cylinder: [rho, phi, z, x, y, *extra])
    feats = box_np_ops.transform_points(cart_points, meta["voxel_shape"])
    feats = feats[:, :meta["n_feat"]].astype(np.float32)
    if feats.shape[1] < meta["n_feat"]:
        feats = np.pad(feats, ((0, 0), (0, meta["n_feat"] - feats.shape[1])))
    pad = np.zeros((meta["max_points"], meta["n_feat"]), np.float32)
    mask = np.zeros((meta["max_points"],), bool)
    k = min(len(feats), meta["max_points"])
    pad[:k] = feats[:k]
    mask[:k] = True

    dev = meta["device"]
    sync_device(dev)
    t0 = time.perf_counter()
    out = predict(torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(
        dev))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    sync_device(dev)
    dt = time.perf_counter() - t0
    keep = out["mask"][0] & (out["scores"][0] >= score_threshold)
    return {"box3d_lidar": out["box3d_lidar"][0][keep],
            "scores": out["scores"][0][keep],
            "label_preds": out["label_preds"][0][keep],
            "time": dt}


def _load_points(path):
    if path.endswith(".npy"):
        return np.load(path)
    raw = np.fromfile(path, dtype=np.float32)
    for width in (5, 4, 3):
        if raw.size % width == 0:
            return raw.reshape(-1, width)
    raise ValueError(f"cannot infer point width of {path}")


def _file_loop(args, cfg):
    _, predict, meta = build_predictor(cfg, args.checkpoint, args.max_points,
                                       args.device)
    seen = set()
    print(f"[single_inference] watching {args.watch_dir}", flush=True)
    while True:
        frames = sorted(f for f in os.listdir(args.watch_dir)
                        if f.endswith((".bin", ".npy")) and f not in seen)
        for f in frames:
            seen.add(f)
            pts = _load_points(os.path.join(args.watch_dir, f))
            det = run_frame(predict, meta, pts, args.score)
            out = os.path.join(args.watch_dir,
                               os.path.splitext(f)[0] + ".det.npz")
            np.savez(out, **{k: v for k, v in det.items() if k != "time"})
            print(f"{f}: {len(det['scores'])} dets in "
                  f"{det['time'] * 1e3:.1f} ms", flush=True)
        if args.once:
            return
        time.sleep(args.poll)


def _ros_loop(args, cfg):  # pragma: no cover - needs a ROS runtime
    import rospy
    import sensor_msgs.point_cloud2 as pc2
    from sensor_msgs.msg import PointCloud2
    from std_msgs.msg import String

    _, predict, meta = build_predictor(cfg, args.checkpoint, args.max_points,
                                       args.device)
    pub = rospy.Publisher(args.out_topic, String, queue_size=1)

    def cb(msg):
        pts = np.array(list(pc2.read_points(
            msg, field_names=("x", "y", "z", "intensity"),
            skip_nans=True)), dtype=np.float32)
        det = run_frame(predict, meta, pts, args.score)
        pub.publish(String(data=repr({
            k: v.tolist() for k, v in det.items() if k != "time"})))

    rospy.init_node("partner_tpu_torch_single_inference")
    rospy.Subscriber(args.topic, PointCloud2, cb, queue_size=1,
                     buff_size=2 ** 24)
    rospy.spin()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--score", type=float, default=0.3)
    p.add_argument("--max_points", type=int, default=200000)
    p.add_argument("--ros", action="store_true")
    p.add_argument("--topic", default="/points_raw")
    p.add_argument("--out_topic", default="/partner_detections")
    p.add_argument("--watch_dir", default="./frames")
    p.add_argument("--poll", type=float, default=0.05)
    p.add_argument("--once", action="store_true",
                   help="process the current files and exit (no watch loop)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.config import load_config

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("single_inference: no CUDA device; pass --device cpu to run "
                 "on the CPU")
    cfg = load_config(args.config)
    if args.ros:
        try:
            import rospy  # noqa: F401
        except ImportError:
            sys.exit("single_inference: --ros needs rospy, which is not "
                     "installed; without --ros frames come from --watch_dir")
        _ros_loop(args, cfg)
    else:
        _file_loop(args, cfg)


if __name__ == "__main__":
    main()
