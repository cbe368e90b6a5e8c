"""Data pipeline stages of the ``train_pipeline`` and ``test_pipeline``
configs (host side, numpy).

Counterpart of ``partner_tpu/data/pipeline.py``; the port cannot import
that module (it imports jax through ``partner_tpu.core`` and
``partner_tpu.ops.voxelize``). Same registry names and ``(res, info)``
contract; the pipeline's output is a padded point buffer (plus, in train
mode, padded targets), and the voxel grid is built on the device inside
the model, unless ``Voxelization`` runs in ``hard`` mode (host voxels,
through the native library where it is built):

  LoadPointCloudFromFile (Waymo frame pickles, or nuScenes ``.bin`` files
  with their sweeps) -> LoadPointCloudAnnotations -> Preprocess
  (train: GT-AUG, flips, rotation, scaling, translation; both modes:
  cart -> polar) -> Voxelization (grid metadata; train: the gt range
  filter) -> [DoubleFlip (test-time flips)] -> AssignLabel (train: center
  targets, vote map, ``global_box``) -> Reformat (data bundle)

Every random draw (the nuScenes sweeps, GT-AUG, the augmentations,
``shuffle_points``) comes from the ``np.random.RandomState`` that the
stage is given (the dataset passes its own to each), in the JAX package's
order, where the JAX package draws from the global ``np.random``: one
seed gives the same batches.

With ``nsectors > 1`` (PolarStream, HAN, STROBE) ``AssignLabel`` assigns
the center targets per sector (cylinder: azimuth slices of the polar
grid; cuboid: wedges of the cartesian grid from -pi), each gaining a
leading sector axis. With
``super_tasks`` holding ``"seg"`` (the seg configs) the nuScenes loader
reads the key frame's lidarseg labels in train and ``debug_gt`` mode only,
where the info has a ``lidarseg_path`` (no ``create_data`` writes one):
the raw ids merged to the 17 classes by ``NUSCENES_SEMANTIC_MAPPING`` (0
= ignore), -1 for the sweeps' rows, as a last column that ``Preprocess``
splits off after the shuffle into ``pc_label`` and ``Reformat`` passes
on (``collate`` makes it ``points_label``).
"""

import pickle

import numpy as np

from ..core import box_np_ops
from ..core.targets import CenterTargetAssigner, draw_votemap
from ..ops.voxelize import VoxelGenerator
from . import augment
from .collate import FLIP_KEYS
from .gt_aug import DataBaseSampler
from .registry import PIPELINES

TRAIN_MODES = ("train", "debug_gt")

# nuScenes lidarseg's 32 raw ids -> the 17 merged classes (0 = ignore)
NUSCENES_SEMANTIC_MAPPING = {
    1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0, 0: 0, 29: 0,
    31: 0, 9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6, 2: 7, 3: 7, 4: 7,
    6: 7, 12: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15,
    30: 16,
}
_SEMANTIC_LUT = np.array([NUSCENES_SEMANTIC_MAPPING[i] for i in range(32)],
                         np.int64)


def read_lidarseg(path):
    """A nuScenes lidarseg ``.bin`` (one uint8 raw id a key-frame point) ->
    the merged classes (N,) int64."""
    return _SEMANTIC_LUT[np.fromfile(path, dtype=np.uint8)]


def get_obj(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def read_file(path, num_point_feature=4):
    """A nuScenes ``.bin`` lidar file (float32 rows of 5: x, y, z,
    intensity, ring index) -> its first ``num_point_feature`` columns."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)[
        :, :num_point_feature]


def remove_close(points_t, radius=1.0):
    """points_t (C, N) -> the columns outside the ``radius`` square around
    the sensor."""
    close = (np.abs(points_t[0]) < radius) & (np.abs(points_t[1]) < radius)
    return points_t[:, ~close]


def read_sweep(sweep):
    """One earlier nuScenes sweep -> (points (N, 4) in the key frame's
    lidar frame, time lag (N, 1)): the points near the sensor dropped, the
    rest moved by the sweep's ``transform_matrix`` where it has one."""
    pts = remove_close(read_file(str(sweep["lidar_path"])).T, 1.0)
    n = pts.shape[1]
    if sweep.get("transform_matrix") is not None:
        pts[:3] = sweep["transform_matrix"].dot(
            np.vstack((pts[:3], np.ones(n))))[:3]
    times = sweep["time_lag"] * np.ones((1, n))
    return pts.T, times.T


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
    """The frame's points. ``WaymoDataset``: the frame pickle (or the
    info's own ``points``), then ``nsweeps - 1`` earlier sweeps with a
    time-lag column. ``NuScenesDataset``: the key frame's ``.bin`` (x, y,
    z, intensity) and, for ``nsweeps > 1``, ``nsweeps - 1`` of the info's
    sweeps drawn from ``rng`` (with replacement only when there are fewer),
    each moved into the key frame; a time-lag column always (0 for the key
    frame), and ``n_key_points``, the key frame's count. With ``"seg"`` in
    ``super_tasks``, in train and ``debug_gt`` mode, and a
    ``lidarseg_path`` in the info: a label column last (the key frame's
    merged classes, -1 on the sweeps' rows) and ``seg_labeled``."""

    def __init__(self, dataset="WaymoDataset", rng=None, **kwargs):
        if dataset not in ("WaymoDataset", "NuScenesDataset"):
            raise NotImplementedError(
                f"{dataset} is not ported to partner_tpu_torch")
        self.super_tasks = kwargs.get("super_tasks", ["det"])
        self.type = dataset
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def __call__(self, res, info):
        res["type"] = self.type
        if self.type == "NuScenesDataset":
            return self._nuscenes(res, info)
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

    def _nuscenes(self, res, info):
        nsweeps = res["lidar"]["nsweeps"]
        if "points" in info:
            points = info["points"]
            times = np.zeros((len(points), 1), points.dtype)
        else:
            points = read_file(str(info["lidar_path"]))
            times = np.zeros((points.shape[0], 1))
        res["lidar"]["n_key_points"] = len(points)
        sweeps = info.get("sweeps")
        if nsweeps > 1 and sweeps:
            sweep_points, sweep_times = [points], [times]
            chosen = self.rng.choice(len(sweeps),
                                     min(nsweeps - 1, len(sweeps)),
                                     replace=len(sweeps) < nsweeps - 1)
            for i in chosen:
                p, t = read_sweep(sweeps[i])
                sweep_points.append(p)
                sweep_times.append(t)
            points = np.concatenate(sweep_points, axis=0)
            times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
        res["lidar"]["points"] = np.hstack([points,
                                            times.astype(points.dtype)])
        if ("seg" in self.super_tasks and res["mode"] in TRAIN_MODES
                and "lidarseg_path" in info):
            labels = read_lidarseg(info["lidarseg_path"])
            pad = np.full((len(points), 1), -1, points.dtype)
            pad[: len(labels), 0] = labels
            res["lidar"]["points"] = np.hstack([res["lidar"]["points"], pad])
            # the last column is a label column: Preprocess splits it off
            res["lidar"]["seg_labeled"] = True
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
    mode does); every mode: the points shuffled if asked, then (with
    ``"seg"`` in ``super_tasks``, in train and ``debug_gt`` mode, on
    labelled points) the label column split off into ``pc_label``, then
    the points to the framework's layout."""

    def __init__(self, cfg=None, rng=None, **kwargs):
        cfg = dict(cfg or {})
        self.mode = cfg.get("mode", "train")
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.voxel_shape = cfg.get("voxel_shape", "cuboid")
        self.class_names = list(cfg.get("class_names", []))
        self.super_tasks = kwargs.get("super_tasks", ["det"])
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
        if ("seg" in self.super_tasks and res["mode"] in TRAIN_MODES
                and res["lidar"].get("seg_labeled")):
            res["lidar"]["pc_label"] = points[:, -1:].copy()
            points = points[:, :-1]
        res["lidar"]["points"] = box_np_ops.transform_points(
            points, self.voxel_shape)
        res["voxel_shape"] = self.voxel_shape
        return res, info


@PIPELINES.register_module(name="Voxelization")
class Voxelization:
    """Records the grid's metadata; voxelizes on the host only in ``hard``
    mode (``ops.voxelize.VoxelGenerator``, up to ``max_voxel_num`` voxels,
    its first entry where it is a list). In ``device`` mode (the default)
    the padded point buffer flows through and the model builds the grid on
    the device. In train mode the gt boxes outside the BEV range are
    dropped first."""

    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg or {})
        self.range = np.asarray(cfg["range"], np.float32)
        self.voxel_size = np.asarray(cfg["voxel_size"], np.float32)
        mv = cfg.get("max_voxel_num", 150000)
        self.max_voxel_num = mv if isinstance(mv, int) else mv[0]
        self.mode = cfg.get("voxelize_mode", "device")
        self.generator = VoxelGenerator(
            self.voxel_size, self.range, cfg.get("max_points_in_voxel", 5),
            self.max_voxel_num)
        self.grid_size = self.generator.grid_size

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
        meta = dict(shape=self.grid_size, range=self.range,
                    size=self.voxel_size)
        if self.mode == "hard":
            voxels, coords, num_points = self.generator.generate(
                res["lidar"]["points"])
            meta.update(voxels=voxels, coordinates=coords,
                        num_points=num_points,
                        num_voxels=np.array([len(voxels)], np.int64))
        res["lidar"]["voxels"] = meta
        return res, info


def _rotate_boxes(boxes, angle):
    """Cartesian boxes [x, y, z, dims..., (vx, vy,) yaw] turned by +angle
    radians about the origin (``partner_tpu/data/pipeline.py:329-341``)."""
    if not len(boxes):
        return boxes
    out = boxes.copy()
    c, s = np.cos(angle), np.sin(angle)
    out[:, 0] = boxes[:, 0] * c - boxes[:, 1] * s
    out[:, 1] = boxes[:, 0] * s + boxes[:, 1] * c
    if boxes.shape[1] >= 9:  # the velocity columns precede yaw
        out[:, -3] = boxes[:, -3] * c - boxes[:, -2] * s
        out[:, -2] = boxes[:, -3] * s + boxes[:, -2] * c
    out[:, -1] = boxes[:, -1] + angle
    return out


@PIPELINES.register_module(name="AssignLabel")
class AssignLabel:
    """Train mode: the center targets of ``CenterTargetAssigner``, the
    padded ``global_box`` [box..., class] (``max_objs`` rows) and the
    vote map. Val mode passes through: no targets at evaluation.

    With ``nsectors > 1`` the center targets are assigned per azimuth
    sector, cylinder or cuboid (:meth:`_assign_sectors`), each target
    gaining a leading sector axis (``collate`` makes it (B, S, ...));
    ``global_box`` and the vote map stay whole-sweep."""

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
        self.nsectors = cfg.get("nsectors", nsectors)

    def _assign_sectors(self, boxes, classes, meta):
        """Per sector s (``pipeline.py:365-406``): the boxes whose center
        azimuth lies in [lo, lo + span), lo = origin + s x span, turned by
        -s x span into sector 0's frame and assigned on the sector grid
        over the sector range; each target stacked over the sectors (a
        per-task list of (S, ...) arrays). Cylinder sectors: origin
        ``range[1]``, span the range's azimuth over S, the grid (n_r,
        n_az / S, nz). Cuboid sectors: origin -pi, span 2 pi / S, the grid
        and range of ``cart_sector_spec``."""
        full_range = np.asarray(meta["range"], np.float32)
        if self.assigner.voxel_shape == "cuboid":
            from ..models.polarstream import cart_sector_spec

            span = 2 * np.pi / self.nsectors
            az_lo = -np.pi
            sec_range, sec_shape = cart_sector_spec(
                full_range, np.asarray(meta["shape"]), self.nsectors)
            sec_range = np.asarray(sec_range, np.float32)
            sec_shape = np.asarray(sec_shape)
        else:
            span = (full_range[4] - full_range[1]) / self.nsectors
            az_lo = full_range[1]
            sec_range = full_range.copy()
            sec_range[4] = sec_range[1] + span
            sec_shape = np.asarray(meta["shape"]).copy()
            sec_shape[1] = sec_shape[1] // self.nsectors
        az = (np.arctan2(boxes[:, 1], boxes[:, 0])
              if len(boxes) else np.zeros((0,)))
        per_sector = []
        for s in range(self.nsectors):
            lo = az_lo + s * span
            m = (az >= lo) & (az < lo + span)
            per_sector.append(self.assigner.assign(
                _rotate_boxes(boxes[m], -s * span), classes[m], sec_shape,
                meta["size"], sec_range))

        def stack(vals):
            if isinstance(vals[0], (list, tuple)):
                return [stack([v[i] for v in vals])
                        for i in range(len(vals[0]))]
            return np.stack(vals)

        return {k: stack([p[k] for p in per_sector]) for k in per_sector[0]}

    def __call__(self, res, info):
        if res.get("mode") not in TRAIN_MODES:
            return res, info
        meta = res["lidar"]["voxels"]
        anno = res["lidar"]["annotations"]
        boxes = anno["gt_boxes"]
        classes = anno["gt_classes"]
        if self.nsectors > 1:
            targets = self._assign_sectors(boxes, classes, meta)
        else:
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


@PIPELINES.register_module(name="DoubleFlip")
class DoubleFlip:
    """Test-time flips of the (cartesian-layout) points for the
    double-flip average: ``yflip_points`` (y negated), ``xflip_points``
    (x negated) and ``double_flip_points`` (both)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, res, info):
        pts = res["lidar"]["points"]
        for key, cols in (("yflip_points", (1,)), ("xflip_points", (0,)),
                          ("double_flip_points", (0, 1))):
            flipped = pts.copy()
            for c in cols:
                flipped[:, c] = -flipped[:, c]
            res["lidar"][key] = flipped
        return res, info


@PIPELINES.register_module(name="Reformat")
class Reformat:
    """The data bundle: points, the grid's metadata, host voxels in hard
    mode, the targets in train mode, ``n_key_points`` in the metadata where
    the loader counted them, the points' seg labels (``pc_label``) where
    ``Preprocess`` split them off, and with ``double_flip`` the three flipped
    copies of the points (``collate`` puts them in the rows after the
    original)."""

    def __init__(self, double_flip=False, **kwargs):
        self.double_flip = double_flip

    def __call__(self, res, info):
        voxels = res["lidar"].get("voxels", {})
        meta = res.get("metadata")
        if isinstance(meta, dict) and "n_key_points" in res["lidar"]:
            meta = dict(meta, n_key_points=res["lidar"]["n_key_points"])
        bundle = dict(metadata=meta)
        bundle["points"] = res["lidar"]["points"]
        bundle["grid_size"] = voxels.get("shape")
        bundle["pc_range"] = voxels.get("range")
        bundle["voxel_size"] = voxels.get("size")
        if "voxels" in voxels:
            bundle.update(voxels=voxels["voxels"],
                          coordinates=voxels["coordinates"],
                          num_points=voxels["num_points"],
                          num_voxels=voxels["num_voxels"])
        if "targets" in res["lidar"]:
            bundle.update(res["lidar"]["targets"])
        if "pc_label" in res["lidar"]:
            bundle["pc_label"] = res["lidar"]["pc_label"]
        if self.double_flip:
            bundle.update({k: res["lidar"][k] for k in FLIP_KEYS
                           if k in res["lidar"]})
        return bundle, info
