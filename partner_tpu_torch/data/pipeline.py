"""Data pipeline stages of the flagship ``test_pipeline`` (host side, numpy).

Counterpart of ``partner_tpu/data/pipeline.py`` for the Waymo val path; the
port cannot import that module (it imports jax through ``partner_tpu.core``
and ``partner_tpu.ops.voxelize``). Same registry names and ``(res, info)``
contract; the pipeline's output is a padded point buffer, and the voxel
grid is built on the device inside the model:

  LoadPointCloudFromFile -> LoadPointCloudAnnotations -> Preprocess (val:
  cart -> polar) -> Voxelization (grid metadata) -> AssignLabel (val: no
  targets) -> Reformat (data bundle)

Not ported, and raising ``NotImplementedError`` where a config asks for
them: train mode (augmentation, GT-AUG, the center targets, vote maps and
``global_box``; ROADMAP.md queue 1, the train-mode data path), host
``hard`` voxelization (ROADMAP.md queue 1, the native host library) and
the nuScenes loader (ROADMAP.md queue 1, nuScenes).
"""

import pickle

import numpy as np

from ..core import box_np_ops
from .registry import PIPELINES

TRAIN_MODES = ("train", "debug_gt")
_TRAIN_TODO = ("train mode is not ported to partner_tpu_torch "
               "(ROADMAP.md queue 1: the train-mode data path)")


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
            points = info["points"]
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
    """Val mode: the points (shuffled if asked) to the framework's layout."""

    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg or {})
        self.mode = cfg.get("mode", "train")
        if self.mode in TRAIN_MODES:
            raise NotImplementedError(_TRAIN_TODO)
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.voxel_shape = cfg.get("voxel_shape", "cuboid")
        self.rng = np.random

    def __call__(self, res, info):
        res["mode"] = self.mode
        points = res["lidar"]["points"]
        if self.shuffle_points:
            self.rng.shuffle(points)
        res["lidar"]["points"] = box_np_ops.transform_points(
            points, self.voxel_shape)
        res["voxel_shape"] = self.voxel_shape
        return res, info


@PIPELINES.register_module(name="Voxelization")
class Voxelization:
    """Records the grid's metadata (``device`` mode): the padded point
    buffer flows through and the model builds the grid on the device."""

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
            raise NotImplementedError(_TRAIN_TODO)
        res["lidar"]["voxels"] = dict(
            shape=self.grid_size, range=self.range, size=self.voxel_size)
        return res, info


@PIPELINES.register_module(name="AssignLabel")
class AssignLabel:
    """Val mode passes through: no targets at evaluation."""

    def __init__(self, cfg=None, **kwargs):
        pass

    def __call__(self, res, info):
        if res.get("mode") in TRAIN_MODES:
            raise NotImplementedError(_TRAIN_TODO)
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
        return bundle, info
