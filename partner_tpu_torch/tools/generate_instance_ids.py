"""Panoptic GT instance ids from boxes and per-point semantic labels
(counterpart of ``tools/generate_instance_ids.py``).

    python -m partner_tpu_torch.tools.generate_instance_ids --info_path I
        --out instance_ids.pkl [--thing_classes 1 2 3]

Every labelled thing-class point inside a GT box gets that box's instance
id (1-based; the first box that holds it); every other point gets 0. Reads
an info pkl whose entries carry ``points``, ``gt_boxes`` and
``points_label``, and writes {token: (P,) int64}. Membership is
``core.box_np_ops.points_in_rbbox`` (the port's native library where it is
built). Host only, so no device flag.
"""

import argparse
import pickle

import numpy as np

from ..core import box_np_ops


def instance_ids_for_frame(points_xyz, labels, gt_boxes, thing_classes):
    inst = np.zeros(len(points_xyz), np.int64)
    if not len(gt_boxes):
        return inst
    b7 = np.concatenate([gt_boxes[:, :6], gt_boxes[:, -1:]], axis=1)
    inside = box_np_ops.points_in_rbbox(points_xyz, b7)  # (P, M)
    thing = np.isin(labels, list(thing_classes))
    for m in range(inside.shape[1]):
        sel = inside[:, m] & thing & (inst == 0)
        inst[sel] = m + 1
    return inst


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--info_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--thing_classes", nargs="*", type=int,
                   default=list(range(1, 11)))
    return p.parse_args(argv)


def main(argv=None):
    """-> {token: instance ids}."""
    args = parse_args(argv)
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    out = {}
    for info in infos:
        pts = np.asarray(info["points"])
        labels = np.asarray(info.get("points_label",
                                     np.zeros(len(pts), np.int64)))
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))))
        out[info.get("token", "")] = instance_ids_for_frame(
            pts[:, :3], labels, boxes, args.thing_classes)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote instance ids for {len(out)} frames -> {args.out}")
    return out


if __name__ == "__main__":
    main()
