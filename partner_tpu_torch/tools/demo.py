"""BEV pictures of detections over a point cloud (counterpart of
``tools/demo.py``).

    python -m partner_tpu_torch.tools.demo --prediction P --info_path I
        [--out_dir demo_out] [--max_frames 5] [--score_threshold 0.3]
        [--export_ply]

Renders each frame's cloud top-down with its detections above the score
threshold (red) and the info's ``gt_boxes`` (green), one PNG a frame;
``--export_ply`` also writes the 3D scene (``utils.viz3d``). The points
come from the info's ``points``, else its ``path`` through the port's data
path (``data.pipeline.get_obj``, ``read_single_waymo``). Host only, so no
device flag. matplotlib is imported when the CLI runs; without it the CLI
exits non-zero naming it.
"""

import argparse
import importlib.util
import os
import pickle
import sys

import numpy as np


def box_corners_bev(boxes):
    """(N, 7+) -> (N, 4, 2) BEV corners."""
    if not len(boxes):
        return np.zeros((0, 4, 2))
    cx, cy = boxes[:, 0], boxes[:, 1]
    dx, dy = boxes[:, 3], boxes[:, 4]
    yaw = boxes[:, -1]
    tmpl = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32) * 0.5
    local = tmpl[None] * np.stack([dx, dy], -1)[:, None, :]
    c, s = np.cos(yaw), np.sin(yaw)
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None] + cx[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None] + cy[:, None]
    return np.stack([x, y], -1)


def render_frame(ax, points_xy, det_boxes=None, gt_boxes=None, extent=80):
    ax.scatter(points_xy[:, 0], points_xy[:, 1], s=0.2, c="#888888",
               linewidths=0)
    for boxes, color in ((gt_boxes, "#2ca02c"), (det_boxes, "#d62728")):
        if boxes is None or not len(boxes):
            continue
        for corners in box_corners_bev(np.asarray(boxes)):
            loop = np.vstack([corners, corners[:1]])
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=0.8)
    ax.set_xlim(-extent, extent)
    ax.set_ylim(-extent, extent)
    ax.set_aspect("equal")
    ax.axis("off")


def frame_points(info):
    """A frame's points: the info's ``points``, else the frame pickle its
    ``path`` names, else none."""
    from ..data.pipeline import get_obj, read_single_waymo

    if "points" in info:
        return np.asarray(info["points"])
    if "path" in info:
        return read_single_waymo(get_obj(info["path"]))
    return np.zeros((0, 3))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prediction", required=True)
    p.add_argument("--info_path", required=True)
    p.add_argument("--out_dir", default="./demo_out")
    p.add_argument("--max_frames", type=int, default=5)
    p.add_argument("--score_threshold", type=float, default=0.3)
    p.add_argument("--export_ply", action="store_true",
                   help="also write a 3D PLY scene per frame (cloud + box "
                        "wireframes, utils/viz3d.py)")
    return p.parse_args(argv)


def main(argv=None):
    """-> the paths written."""
    args = parse_args(argv)
    if importlib.util.find_spec("matplotlib") is None:
        sys.exit("demo: the BEV pictures need matplotlib, which is not "
                 "installed (write_ply_scene in utils/viz3d.py needs only "
                 "numpy)")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.viz3d import write_ply_scene

    with open(args.prediction, "rb") as f:
        dets = pickle.load(f)
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    infos_by_token = {i.get("token", ""): i for i in infos}

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for n, (tok, d) in enumerate(dets.items()):
        if n >= args.max_frames:
            break
        info = infos_by_token.get(tok, {})
        pts = frame_points(info)
        boxes = np.asarray(d["box3d_lidar"])
        scores = np.asarray(d["scores"])
        boxes = boxes[scores > args.score_threshold]

        fig, ax = plt.subplots(figsize=(8, 8), dpi=120)
        render_frame(ax, pts[:, :2], det_boxes=boxes,
                     gt_boxes=info.get("gt_boxes"))
        out = os.path.join(args.out_dir, f"{tok or n}.png")
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
        print("wrote", out)
        written.append(out)

        if args.export_ply:
            ply = write_ply_scene(
                os.path.join(args.out_dir, f"{tok or n}.ply"),
                pts, det_boxes=boxes, gt_boxes=info.get("gt_boxes"))
            print("wrote", ply)
            written.append(ply)
    return written


if __name__ == "__main__":
    main()
