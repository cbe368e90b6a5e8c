"""Dataset classes (counterpart of ``partner_tpu/data/datasets.py``):
``PointCloudDataset`` over an info pkl and a pipeline, with its sampler
group ``flag``; the ``ConcatDataset`` and ``RepeatDataset`` wrappers, whose
flags keep each source its own group; and ``WaymoDataset`` and
``NuScenesDataset`` with their ``evaluation``. A dataset hands its ``rng``
(an ``np.random.RandomState``) to its pipeline, whose stages draw from it
(the nuScenes sweeps in every mode, the augmentations in train mode).
"""

import pickle

import numpy as np

from .registry import DATASETS, Compose


class PointCloudDataset:
    """Base dataset: info list + pipeline (datasets/custom.py:12-190)."""

    NumPointFeatures = -1

    def __init__(self, root_path, info_path, pipeline=None, test_mode=False,
                 class_names=None, nsweeps=1, load_interval=1, mode="train",
                 rng=None, **kwargs):
        self._root_path = root_path
        self._info_path = info_path
        self.test_mode = test_mode or mode in ("val", "test")
        self.mode = mode
        self._class_names = class_names or []
        self.nsweeps = nsweeps
        self.load_interval = load_interval
        self._infos = None
        self.pipeline = (Compose(pipeline, dict(rng=rng))
                         if pipeline is not None else None)

    def load_infos(self):
        with open(self._info_path, "rb") as f:
            infos = pickle.load(f)
        self._infos = infos[:: self.load_interval]

    @property
    def infos(self):
        if self._infos is None:
            self.load_infos()
        return self._infos

    def __len__(self):
        return len(self.infos)

    @property
    def flag(self):
        """Sampler group per sample: one group (0) for a single dataset."""
        if getattr(self, "_flag", None) is None:
            self._flag = np.zeros(len(self), dtype=np.uint8)
        return self._flag

    def base_res(self, info):
        return {
            "lidar": {"type": "lidar", "points": None, "annotations": None,
                      "nsweeps": self.nsweeps},
            "metadata": {
                "image_prefix": self._root_path,
                "num_point_features": self.NumPointFeatures,
                "token": info.get("token", ""),
            },
            "calib": None,
            "mode": "val" if self.test_mode else "train",
            "type": type(self).__name__,
        }

    def __getitem__(self, idx):
        info = self.infos[idx]
        res = self.base_res(info)
        data, _ = self.pipeline(res, info)
        return data


@DATASETS.register_module(name="ConcatDataset")
class ConcatDataset:
    """Concatenated datasets, each source its own sampler group: a source's
    flags are offset by one more than the largest flag before it
    (``datasets.py:83-112``)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])
        flags = []
        offset = 0
        for d in self.datasets:
            f = getattr(d, "flag", np.zeros(len(d), np.uint8))
            f = np.asarray(f).astype(np.int64)
            flags.append(f + offset)
            offset += 1 + (int(f.max()) if len(f) else 0)
        self.flag = (np.concatenate(flags) if flags
                     else np.zeros(0, np.int64))

    def __len__(self):
        return int(self.cum[-1]) if len(self.datasets) else 0

    def __getitem__(self, idx):
        src = int(np.searchsorted(self.cum, idx, side="right"))
        base = int(self.cum[src - 1]) if src else 0
        return self.datasets[src][idx - base]


@DATASETS.register_module(name="RepeatDataset")
class RepeatDataset:
    """``len(dataset) * times`` samples, the flags tiled
    (``datasets.py:115-129``)."""

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        f = getattr(dataset, "flag", np.zeros(len(dataset), np.uint8))
        self.flag = np.tile(np.asarray(f), times)

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


@DATASETS.register_module(name="WaymoDataset")
class WaymoDataset(PointCloudDataset):
    NumPointFeatures = 5  # x, y, z, intensity, elongation

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.nsweeps > 1:
            self.NumPointFeatures += 1

    def evaluation(self, detections, output_dir=None, testset=False):
        """Writes the devkit bin AND computes official-protocol LEVEL_1 /
        LEVEL_2 AP/APH with range breakdowns (eval/waymo_protocol.py —
        Hungarian matching per score cutoff, difficulty from num_points /
        labeler flags; the reference defers entirely to the external
        devkit, waymo/waymo.py:94-104). The quick greedy AP/APH of
        eval/detection_metrics.py is reported under legacy keys."""
        from ..eval.detection_metrics import gts_from_infos, waymo_ap_aph
        from ..eval.waymo import create_pd_detection
        from ..eval.waymo_protocol import waymo_official_metrics

        create_pd_detection(detections, self.infos, output_dir)
        if testset:
            return None, None
        classes = list(self._class_names) or ["Vehicle", "Pedestrian",
                                              "Cyclist"]
        gts = gts_from_infos(self.infos, classes)
        metrics = waymo_official_metrics(detections, gts, classes)
        legacy = waymo_ap_aph(detections, gts, classes)
        metrics.update({f"greedy/{k}": v for k, v in legacy.items()})
        return metrics, None


@DATASETS.register_module(name="NuScenesDataset")
class NuScenesDataset(PointCloudDataset):
    """nuScenes infos (``tools/create_data.py nuscenes_data_prep``): a
    key-frame ``lidar_path``, its ``sweeps`` (each a ``lidar_path``, a
    ``transform_matrix`` into the key frame and a ``time_lag``), gt boxes
    (N, 9) [x, y, z, dx, dy, dz, vx, vy, yaw] with ``gt_names``, and the
    lidar -> ego -> global calibration the results writer uses."""

    NumPointFeatures = 4  # x, y, z, intensity
    # the loader appends the time-lag channel at every nsweeps
    ExtraPointChannels = 1

    CLASSES = (
        "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
        "motorcycle", "bicycle", "pedestrian", "traffic_cone",
    )
    SEG_CLASSES = 17  # lidarseg's 32 ids merged to 17 classes (0 = ignore)

    def __init__(self, *args, version="v1.0-trainval", **kwargs):
        super().__init__(*args, **kwargs)
        self.version = version

    def base_res(self, info):
        res = super().base_res(info)
        res["lidar"]["transform_type"] = "raw"
        res["painted"] = False
        return res

    def evaluation(self, detections, output_dir=None, testset=False,
                   final_seg=None, final_ins=None):
        """Writes ``results_nusc.json`` (``eval/nuscenes.py``) and, unless
        ``testset``, computes the devkit-protocol metrics
        (``eval/nusc_protocol.py``: mAP, NDS, TP errors), the quick greedy
        ones under ``greedy/`` and the json's path under ``results_path``.
        With ``final_seg`` ({token: {"pred", "gt"}} per-point classes) the
        seg mIoU: one confusion matrix over every frame's points, the mean
        IoU of classes 1-16 (NaN classes left out); with ``final_ins``
        ({token: {"pred_sem", "pred_inst", "gt_sem", "gt_inst"}}) the
        panoptic {"PQ", "SQ", "RQ"}, class 0 ignored.
        Returns (det metrics, seg mIoU, panoptic), the JAX package's
        3-tuple, each None where it has no input."""
        from ..eval.detection_metrics import gts_from_infos, nusc_map_nds
        from ..eval.nusc_protocol import nusc_official_metrics
        from ..eval.nuscenes import write_nusc_results
        from ..eval.seg_metrics import PanopticEval, fast_hist, per_class_iou

        path = write_nusc_results(detections, self.infos, output_dir,
                                  self.CLASSES)
        det_metrics = None
        if detections and not testset:
            classes = list(self._class_names) or list(self.CLASSES)
            gts = gts_from_infos(self.infos, classes)
            det_metrics = nusc_official_metrics(detections, gts, classes)
            legacy = nusc_map_nds(detections, gts, classes)
            det_metrics.update({f"greedy/{k}": v for k, v in legacy.items()})
            det_metrics["results_path"] = path

        seg_miou = None
        if final_seg:
            n = self.SEG_CLASSES
            hist = np.zeros((n, n), np.int64)
            for s in final_seg.values():
                hist += fast_hist(np.asarray(s["pred"]).ravel(),
                                  np.asarray(s["gt"]).ravel(), n)
            seg_miou = float(np.nanmean(per_class_iou(hist)[1:]))

        panoptic = None
        if final_ins:
            pe = PanopticEval(self.SEG_CLASSES, ignore=[0])
            for s in final_ins.values():
                pe.addBatch(np.asarray(s["pred_sem"]),
                            np.asarray(s["pred_inst"]),
                            np.asarray(s["gt_sem"]),
                            np.asarray(s["gt_inst"]))
            pq, sq, rq = pe.getPQ()[:3]
            panoptic = {"PQ": float(pq), "SQ": float(sq), "RQ": float(rq)}
        return det_metrics, seg_miou, panoptic
