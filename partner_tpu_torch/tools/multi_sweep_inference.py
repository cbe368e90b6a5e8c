"""Offline streaming multi-sweep inference of the port (counterpart of
``tools/multi_sweep_inference.py``).

    python -m partner_tpu_torch.tools.multi_sweep_inference CONFIG
        --info_path INFOS [--nsweeps 5] [--checkpoint CKPT]
        [--max_points P] [--max_frames N] [--work_dir D] [--device cuda|cpu]

Frames come from an info pkl in timestamp order (each info's ``points``,
or its frame pickle at ``path``; its ``pose``, 4 x 4 ego -> world, and
``timestamp``). A deque keeps the last ``--nsweeps`` sweeps; each frame
moves every kept sweep into the current ego frame by ``inv(pose) @
sweep_pose`` (computed in float64, applied in float32), appends each
sweep's time lag behind the current frame as a channel, concatenates the
sweeps, takes the config's point layout (``transform_points``), and runs
the detector's voxel path: voxels on the device
(``ops.voxelize.dynamic_voxelize``, up to ``max_voxel_num`` voxels, its
first entry where it is a list), then ``predict``. The kept boxes of each frame go to ``prediction.pkl`` in
``--work_dir`` (keyed by token); the middle third of the frames' times
gives the printed FPS. This is how the two-sweep velocity CenterPoint
config is served (``--nsweeps 2``).

Runs on the card unless ``--device cpu``; with no card it stops with an
error. ``--checkpoint`` reads a port or a JAX checkpoint; without one the
weights come from a seeded ``torch.Generator`` (seed 0).
"""

import argparse
import os
import pickle
import sys
import time
from collections import deque

import numpy as np
import torch


def transform_points(points, tm):
    """Rows' xyz moved by the 4 x 4 ``tm`` (its dtype), other columns
    kept."""
    out = points.copy()
    hom = np.concatenate(
        [points[:, :3], np.ones((len(points), 1), points.dtype)], axis=1)
    out[:, :3] = (tm @ hom.T).T[:, :3]
    return out


def frame_points(sweeps, pose, ts, voxel_shape, n_feat):
    """The kept ``sweeps`` ((cartesian points, pose, timestamp), oldest
    first) in the ego frame of ``pose`` at ``ts``, each with its time lag
    as a channel, concatenated and laid out as the config's points ->
    (N, n_feat) float32."""
    from ..core import box_np_ops

    inv = np.linalg.inv(pose)
    chunks = []
    for sp, spose, sts in sweeps:
        rel = inv @ spose
        moved = transform_points(sp.astype(np.float32),
                                 rel.astype(np.float32))
        lag = np.full((len(moved), 1), ts - sts, np.float32)
        chunks.append(np.concatenate([moved, lag], axis=1))
    cat = np.concatenate(chunks)
    polar = box_np_ops.transform_points(cat[:, :3], voxel_shape)
    return np.concatenate([polar, cat[:, 3:]], axis=1)[:, :n_feat]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--info_path", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--nsweeps", type=int, default=5)
    p.add_argument("--max_points", type=int, default=200000)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--work_dir", default="./msi_out")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """-> (detections {token: kept boxes}, middle-third FPS)."""
    args = parse_args(argv)
    from ..data.pipeline import get_obj, read_single_waymo
    from .single_inference import build_predictor, sync_device
    from ..utils.config import load_config

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("multi_sweep_inference: no CUDA device; pass --device cpu "
                 "to run on the CPU")
    cfg = load_config(args.config)
    _, predict, meta = build_predictor(cfg, args.checkpoint, args.max_points,
                                       args.device)
    dev = meta["device"]

    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    infos.sort(key=lambda i: i.get("timestamp", 0))

    sweeps = deque(maxlen=args.nsweeps)   # (cartesian points, pose, time)
    detections, times = {}, []
    for n, info in enumerate(infos):
        if args.max_frames and n >= args.max_frames:
            break
        pts = (info["points"] if "points" in info
               else read_single_waymo(get_obj(info["path"])))
        pose = np.asarray(info.get("pose", np.eye(4)), np.float64)
        ts = float(info.get("timestamp", n))
        sweeps.append((pts, pose, ts))
        feats = frame_points(sweeps, pose, ts, meta["voxel_shape"],
                             meta["n_feat"])
        pad = np.zeros((args.max_points, meta["n_feat"]), np.float32)
        mask = np.zeros((args.max_points,), bool)
        k = min(len(feats), args.max_points)
        pad[:k] = feats[:k]
        mask[:k] = True

        sync_device(dev)
        t0 = time.perf_counter()
        out = predict(torch.from_numpy(pad).to(dev),
                      torch.from_numpy(mask).to(dev))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        sync_device(dev)
        times.append(time.perf_counter() - t0)
        m = out["mask"][0]
        detections[info.get("token", str(n))] = {
            "box3d_lidar": out["box3d_lidar"][0][m],
            "scores": out["scores"][0][m],
            "label_preds": out["label_preds"][0][m],
        }

    os.makedirs(args.work_dir, exist_ok=True)
    with open(os.path.join(args.work_dir, "prediction.pkl"), "wb") as f:
        pickle.dump(detections, f)
    third = max(1, len(times) // 3)
    window = times[third: 2 * third] or times
    fps = len(window) / sum(window)
    print(f"{len(detections)} frames; middle-third FPS {fps:.2f}",
          flush=True)
    return detections, fps


if __name__ == "__main__":
    main()
