"""Data pipeline stages of the flagship ``train_pipeline`` and
``test_pipeline`` (host side, numpy).

Counterpart of ``partner_tpu/data/pipeline.py``; the port cannot import
that module (it imports jax through ``partner_tpu.core`` and
``partner_tpu.ops.voxelize``). Same registry names and ``(res, info)``
contract; the pipeline's output is a padded point buffer (plus, in train
mode, padded targets), and the voxel grid is built on the device inside
the model:

  LoadPointCloudFromFile -> LoadPointCloudAnnotations -> Preprocess
  (train: GT-AUG, flips, rotation, scaling, translation; both modes:
  cart -> polar) -> Voxelization (grid metadata; train: the gt range
  filter) -> AssignLabel (train: center targets, vote map, ``global_box``)
  -> Reformat (data bundle)

Every random draw (GT-AUG, the augmentations, ``shuffle_points``) comes
from the ``np.random.RandomState`` that ``Preprocess`` is given (the
dataset passes its own), in the JAX package's order, where the JAX package
draws from the global ``np.random``: one seed gives the same batches.

Not ported, and raising ``NotImplementedError`` where a config asks for
them: host ``hard`` voxelization (ROADMAP.md queue 1, the native host
library), the nuScenes loader (ROADMAP.md queue 1, nuScenes), sector
targets (``nsectors > 1``, PolarStream) and the seg labels (``seg_head``;
both ROADMAP.md queue 1, off the main path).
"""

import pickle

import numpy as np

from ..core import box_np_ops
from ..core.targets import CenterTargetAssigner, draw_votemap
from . import augment
from .gt_aug import DataBaseSampler
from .registry import PIPELINES

TRAIN_MODES = ("train", "debug_gt")


def get_obj(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def read_single_waymo(obj):
    xyz = obj["lidars"]["points_xyz"]
    feat = obj["lidars"]["points_feature"].copy()
    feat[:, 0] = np.tanh(feat[:, 0])
    return np.concatenate([xyz, feat], axis=-1)


def read_single_waymo_sweep(sweep):
    pts = read_single_waymo(get_obj(sweep["path"])).T
    n = pts.shape[1]
    if sweep.get("transform_matrix") is not None:
        pts[:3] = sweep["transform_matrix"].dot(
            np.vstack((pts[:3], np.ones(n))))[:3]
    times = sweep["time_lag"] * np.ones((1, n))
    return pts.T, times.T


@PIPELINES.register_module(name="LoadPointCloudFromFile")
class LoadPointCloudFromFile:
    def __init__(self, dataset="WaymoDataset", **kwargs):
        if dataset != "WaymoDataset":
            raise NotImplementedError(
                f"{dataset} is not ported to partner_tpu_torch (ROADMAP.md "
                "queue 1: nuScenes)")
        self.type = dataset

    def __call__(self, res, info):
        res["type"] = self.type
        nsweeps = res["lidar"]["nsweeps"]
        if "points" in info:  # pre-materialized (synthetic / test)
            # a copy: the train stages flip, rotate, scale and shuffle the
            # points in place, and the info must stay as it was for the
            # next epoch (the JAX package hands out the info's own array)
            points = info["points"].copy()
        else:
            points = read_single_waymo(get_obj(info["path"]))
        if nsweeps > 1:
            sweep_points = [points]
            sweep_times = [np.zeros((points.shape[0], 1))]
            for sweep in info["sweeps"][: nsweeps - 1]:
                p, t = read_single_waymo_sweep(sweep)
                sweep_points.append(p)
                sweep_times.append(t)
            points = np.concatenate(sweep_points, axis=0)
            times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
            points = np.hstack([points, times])
        res["lidar"]["points"] = points
        return res, info


@PIPELINES.register_module(name="LoadPointCloudAnnotations")
class LoadPointCloudAnnotations:
    def __init__(self, with_bbox=True, **kwargs):
        pass

    def __call__(self, res, info):
        if "gt_boxes" in info:
            boxes = np.asarray(info["gt_boxes"], np.float32)
            boxes[np.isnan(boxes)] = 0
            res["lidar"]["annotations"] = {
                "boxes": boxes,
                "names": np.asarray(info["gt_names"]),
            }
        return res, info


@PIPELINES.register_module(name="Preprocess")
class Preprocess:
    """Train mode: the names filtered, GT-AUG, the class filter and
    ``gt_classes`` (1-based), then flips, rotation, scaling and translation
    (``no_augmentation`` keeps only the class filter, as ``debug_gt``
    mode does); every mode: the points shuffled if asked, then to the
    framework's layout."""

    def __init__(self, cfg=None, rng=None, **kwargs):
        cfg = dict(cfg or {})
        self.mode = cfg.get("mode", "train")
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.voxel_shape = cfg.get("voxel_shape", "cuboid")
        self.class_names = list(cfg.get("class_names", []))
        if "seg" in kwargs.get("super_tasks", ["det"]):
            raise NotImplementedError(
                "seg labels are not ported to partner_tpu_torch (ROADMAP.md "
                "queue 1, off the main path: seg_head)")
        self.no_augmentation = cfg.get("no_augmentation", False)
        self.rng = rng if rng is not None else np.random.RandomState(0)
        if self.mode == "train":
            self.global_rot_noise = cfg.get("global_rot_noise", [0, 0])
            self.global_scale_noise = cfg.get("global_scale_noise", [1, 1])
            self.global_translate_std = cfg.get("global_translate_std", 0)
            db = cfg.get("db_sampler")
            self.db_sampler = None
            if db and db.get("enable", False):
                with open(db["db_info_path"], "rb") as f:
                    db_infos = pickle.load(f)
                self.db_sampler = DataBaseSampler(
                    db_infos, db["sample_groups"], db.get("db_prep_steps"),
                    db.get("rate", 1.0), rng=self.rng)

    def _class_ids(self, gt_dict, gt_mask):
        gt_dict = {k: v[gt_mask] for k, v in gt_dict.items()}
        gt_dict["gt_classes"] = np.array(
            [self.class_names.index(n) + 1 for n in gt_dict["gt_names"]],
            np.int32)
        return gt_dict

    def __call__(self, res, info):
        res["mode"] = self.mode
        points = res["lidar"]["points"]

        if self.mode in TRAIN_MODES:
            anno = res["lidar"]["annotations"]
            gt_dict = {"gt_boxes": anno["boxes"],
                       "gt_names": np.asarray(anno["names"]).reshape(-1)}

        if self.mode == "train" and not self.no_augmentation:
            keep = np.array([n not in ("DontCare", "ignore", "UNKNOWN")
                             for n in gt_dict["gt_names"]], bool)
            gt_dict = {k: v[keep] for k, v in gt_dict.items()}
            gt_mask = np.array(
                [n in self.class_names for n in gt_dict["gt_names"]], bool)
            if self.db_sampler is not None:
                sampled = self.db_sampler.sample_all(
                    res["metadata"]["image_prefix"], gt_dict["gt_boxes"],
                    gt_dict["gt_names"],
                    res["metadata"]["num_point_features"])
                if sampled is not None:
                    # sampled objects go before the frame's points; boxes
                    # take numpy's promotion of the two dtypes
                    gt_dict["gt_names"] = np.concatenate(
                        [gt_dict["gt_names"], sampled["gt_names"]])
                    gt_dict["gt_boxes"] = np.concatenate(
                        [gt_dict["gt_boxes"], sampled["gt_boxes"]])
                    gt_mask = np.concatenate([gt_mask, sampled["gt_masks"]])
                    points = np.concatenate(
                        [sampled["points"][:, : points.shape[1]], points])
            gt_dict = self._class_ids(gt_dict, gt_mask)
            boxes = gt_dict["gt_boxes"]
            boxes, points = augment.random_flip_both(boxes, points,
                                                     rng=self.rng)
            boxes, points = augment.global_rotation(
                boxes, points, self.global_rot_noise, rng=self.rng)
            boxes, points = augment.global_scaling(
                boxes, points, *self.global_scale_noise, rng=self.rng)
            boxes, points = augment.global_translate(
                boxes, points, self.global_translate_std, rng=self.rng)
            gt_dict["gt_boxes"] = boxes
        elif self.mode in TRAIN_MODES:
            gt_dict = self._class_ids(gt_dict, np.array(
                [n in self.class_names for n in gt_dict["gt_names"]], bool))

        if self.shuffle_points:
            self.rng.shuffle(points)
        if self.mode in TRAIN_MODES:
            res["lidar"]["annotations"] = gt_dict
        res["lidar"]["points"] = box_np_ops.transform_points(
            points, self.voxel_shape)
        res["voxel_shape"] = self.voxel_shape
        return res, info


@PIPELINES.register_module(name="Voxelization")
class Voxelization:
    """Records the grid's metadata (``device`` mode): the padded point
    buffer flows through and the model builds the grid on the device. In
    train mode the gt boxes outside the BEV range are dropped first."""

    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg or {})
        self.range = np.asarray(cfg["range"], np.float32)
        self.voxel_size = np.asarray(cfg["voxel_size"], np.float32)
        if cfg.get("voxelize_mode", "device") != "device":
            raise NotImplementedError(
                "host hard voxelization is not ported to partner_tpu_torch "
                "(ROADMAP.md queue 1: the native host library)")
        # as partner_tpu/ops/voxelize.py's VoxelGenerator: float32, rounded
        grid = (self.range[3:] - self.range[:3]) / self.voxel_size
        self.grid_size = np.round(grid).astype(np.int64)

    def __call__(self, res, info):
        if res.get("mode") in TRAIN_MODES:
            anno = res["lidar"]["annotations"]
            if len(anno["gt_boxes"]):
                bv = self.range[[0, 1, 3, 4]]
                if res.get("voxel_shape") == "cuboid":
                    m = box_np_ops.filter_gt_cart_range(anno["gt_boxes"], bv)
                else:
                    m = box_np_ops.filter_gt_polar_range(anno["gt_boxes"], bv)
                res["lidar"]["annotations"] = {k: v[m]
                                               for k, v in anno.items()}
        res["lidar"]["voxels"] = dict(
            shape=self.grid_size, range=self.range, size=self.voxel_size)
        return res, info


@PIPELINES.register_module(name="AssignLabel")
class AssignLabel:
    """Train mode: the center targets of ``CenterTargetAssigner``, the
    padded ``global_box`` [box..., class] (``max_objs`` rows) and the
    vote map. Val mode passes through: no targets at evaluation."""

    def __init__(self, cfg=None, rectify=False, with_votemap=True,
                 with_global_box=True, nsectors=1, **kwargs):
        cfg = dict(cfg or {})
        self.tasks = [dict(t) for t in
                      dict(cfg.get("target_assigner", {})).get("tasks", [])]
        self.assigner = CenterTargetAssigner(
            tasks=self.tasks,
            out_size_factor=cfg.get("out_size_factor", 8),
            gaussian_overlap=cfg.get("gaussian_overlap", 0.1),
            max_objs=cfg.get("max_objs", 500),
            min_radius=cfg.get("min_radius", 2),
            voxel_shape=cfg.get("voxel_shape", "cylinder"),
            rectify=rectify)
        self.max_objs = cfg.get("max_objs", 500)
        self.with_votemap = with_votemap
        self.with_global_box = with_global_box
        if cfg.get("nsectors", nsectors) > 1:
            raise NotImplementedError(
                "sector targets (nsectors > 1) are not ported to "
                "partner_tpu_torch (ROADMAP.md queue 1, off the main path: "
                "PolarStream)")

    def __call__(self, res, info):
        if res.get("mode") not in TRAIN_MODES:
            return res, info
        meta = res["lidar"]["voxels"]
        anno = res["lidar"]["annotations"]
        boxes = anno["gt_boxes"]
        classes = anno["gt_classes"]
        targets = self.assigner.assign(boxes, classes, meta["shape"],
                                       meta["size"], meta["range"])
        if self.with_global_box:
            ncol = boxes.shape[1] if len(boxes) else 7
            gb = np.zeros((self.max_objs, ncol + 1), np.float32)
            m = min(len(boxes), self.max_objs)
            if m:
                gb[:m, :ncol] = boxes[:m]
                gb[:m, -1] = classes[:m]
            targets["global_box"] = gb
        if self.with_votemap:
            n_cls = sum(len(t["class_names"]) for t in self.tasks)
            cls0 = classes - 1 if len(classes) else classes
            targets["votemap"] = draw_votemap(
                boxes[..., [0, 1, 2, 3, 4, 5, -1]] if len(boxes) else boxes,
                cls0, n_cls, meta["shape"], meta["size"], meta["range"],
                feature_map_stride=self.assigner.out_size_factor)
        res["lidar"]["targets"] = targets
        return res, info


@PIPELINES.register_module(name="Reformat")
class Reformat:
    def __init__(self, **kwargs):
        pass

    def __call__(self, res, info):
        voxels = res["lidar"].get("voxels", {})
        bundle = dict(metadata=res.get("metadata"))
        bundle["points"] = res["lidar"]["points"]
        bundle["grid_size"] = voxels.get("shape")
        bundle["pc_range"] = voxels.get("range")
        bundle["voxel_size"] = voxels.get("size")
        if "targets" in res["lidar"]:
            bundle.update(res["lidar"]["targets"])
        return bundle, info
