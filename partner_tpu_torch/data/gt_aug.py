"""GT-AUG: ground-truth database sampling with collision rejection.

Counterpart of ``partner_tpu/data/gt_aug.py:20-160``: per-class quotas
topped up from a database of cropped gt objects, each inserted only where
its BEV box collides with no existing box and no box sampled before it.
Every draw comes from the ``np.random.RandomState`` given at construction,
in the JAX package's order (each class's list shuffled at construction,
reshuffled when a class wraps), so one seed gives the same samples in both
packages.

db_infos (``tools/create_data.py:create_groundtruth_database``):
{class_name: [{'name', 'path', 'box3d_lidar' (7 or 9), 'num_points_in_gt',
'difficulty', ...}, ...]}, each ``path`` relative to the dataset root and
holding float32 points shifted to the box center.
"""

import pathlib
import threading

import numpy as np

from ..core import box_np_ops
from .augment import box_collision_test


class BatchSampler:
    """Shuffled, epoch-cycling sampler over one class's db entries. The
    loader's threads share it, so a draw holds its lock."""

    def __init__(self, sampled_list, shuffle=True, *, rng):
        self._list = sampled_list
        self._indices = np.arange(len(sampled_list))
        self._rng = rng
        self._shuffle = shuffle
        self._lock = threading.Lock()
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num):
        with self._lock:
            if self._idx + num >= len(self._list):
                ret = self._indices[self._idx :].copy()
                if self._shuffle:
                    self._rng.shuffle(self._indices)
                self._idx = 0
            else:
                ret = self._indices[self._idx : self._idx + num].copy()
                self._idx += num
        return [self._list[i] for i in ret]


def filter_by_difficulty(db_infos, removed_difficulties):
    return {
        k: [info for info in v
            if info.get("difficulty", 0) not in removed_difficulties]
        for k, v in db_infos.items()
    }


def filter_by_min_num_points(db_infos, min_points_dict):
    for name, min_num in min_points_dict.items():
        if min_num > 0 and name in db_infos:
            db_infos[name] = [
                info for info in db_infos[name]
                if info.get("num_points_in_gt", min_num) >= min_num
            ]
    return db_infos


class DataBaseSampler:
    def __init__(self, db_infos, sample_groups, db_prep_steps=None, rate=1.0,
                 *, rng, **kwargs):
        self._rng = rng
        for prep in db_prep_steps or []:
            if "filter_by_difficulty" in prep:
                db_infos = filter_by_difficulty(
                    db_infos, prep["filter_by_difficulty"])
            if "filter_by_min_num_points" in prep:
                db_infos = filter_by_min_num_points(
                    db_infos, dict(prep["filter_by_min_num_points"]))
        self.db_infos = db_infos
        self._rate = rate
        self._sample_classes = []
        self._sample_max_nums = []
        for group in sample_groups:
            self._sample_classes += list(group.keys())
            self._sample_max_nums += list(group.values())
        self._sampler_dict = {
            k: BatchSampler(v, rng=self._rng) for k, v in db_infos.items() if v
        }

    def sample_all(self, root_path, gt_boxes, gt_names, num_point_features,
                   **kwargs):
        """-> {"gt_names", "difficulty", "gt_boxes", "points" (the sampled
        objects' points moved to their boxes), "gt_masks"}, or None when
        nothing was inserted."""
        sampled, sampled_boxes_list = [], []
        avoid = gt_boxes

        for class_name, max_num in zip(self._sample_classes,
                                       self._sample_max_nums):
            if class_name not in self._sampler_dict:
                continue
            n = int(max_num - np.sum([x == class_name for x in gt_names]))
            n = int(np.round(self._rate * n))
            if n <= 0:
                continue
            picked = self._sample_class(class_name, n, avoid)
            sampled += picked
            if picked:
                boxes = np.stack([s["box3d_lidar"] for s in picked])
                sampled_boxes_list.append(boxes)
                avoid = np.concatenate([avoid, boxes], axis=0)

        if not sampled:
            return None
        sampled_boxes = np.concatenate(sampled_boxes_list, axis=0)
        pts_list = []
        keep = []
        for i, info in enumerate(sampled):
            try:
                p = np.fromfile(
                    str(pathlib.Path(root_path) / info["path"]),
                    dtype=np.float32,
                ).reshape(-1, num_point_features)
            except (OSError, ValueError):
                continue
            p = p.copy()
            p[:, :3] += info["box3d_lidar"][:3]
            pts_list.append(p)
            keep.append(i)
        if not pts_list:
            return None
        sampled = [sampled[i] for i in keep]
        sampled_boxes = sampled_boxes[keep]
        return {
            "gt_names": np.array([s["name"] for s in sampled]),
            "difficulty": np.array([s.get("difficulty", 0) for s in sampled]),
            "gt_boxes": sampled_boxes,
            "points": np.concatenate(pts_list, axis=0),
            "gt_masks": np.ones((len(sampled),), dtype=bool),
        }

    def _sample_class(self, name, num, gt_boxes):
        cand = self._sampler_dict[name].sample(num)
        cand = [dict(c) for c in cand]
        if not cand:
            return []
        num_gt = gt_boxes.shape[0]
        sp_boxes = np.stack([c["box3d_lidar"] for c in cand])

        gt_bv = box_np_ops.center_to_corner_box2d(
            gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, -1])
        sp_bv = box_np_ops.center_to_corner_box2d(
            sp_boxes[:, :2], sp_boxes[:, 3:5], sp_boxes[:, -1])
        total = np.concatenate([gt_bv, sp_bv], axis=0)
        coll = box_collision_test(total, total)
        np.fill_diagonal(coll, False)

        valid = []
        for i in range(num_gt, num_gt + len(cand)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                valid.append(cand[i - num_gt])
        return valid
