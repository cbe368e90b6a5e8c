"""Dataset classes of the Waymo val path (counterpart of
``partner_tpu/data/datasets.py``): ``PointCloudDataset`` over an info pkl
and a pipeline, and ``WaymoDataset`` with its ``evaluation``. Not ported:
the ``ConcatDataset`` / ``RepeatDataset`` wrappers and the sampler groups
(``flag``) they carry (ROADMAP.md queue 1: the train-mode data path), and
``NuScenesDataset`` (ROADMAP.md queue 1: nuScenes).
"""

import pickle

from .registry import DATASETS, Compose


class PointCloudDataset:
    """Base dataset: info list + pipeline (datasets/custom.py:12-190)."""

    NumPointFeatures = -1

    def __init__(self, root_path, info_path, pipeline=None, test_mode=False,
                 class_names=None, nsweeps=1, load_interval=1, mode="train",
                 **kwargs):
        self._root_path = root_path
        self._info_path = info_path
        self.test_mode = test_mode or mode in ("val", "test")
        self.mode = mode
        self._class_names = class_names or []
        self.nsweeps = nsweeps
        self.load_interval = load_interval
        self._infos = None
        self.pipeline = Compose(pipeline) if pipeline is not None else None

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
