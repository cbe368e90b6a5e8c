"""nuScenes evaluation in partner_tpu_torch against partner_tpu (CPU).

The port's ``eval/nusc_protocol.py`` and ``eval/nuscenes.py`` are copies of
the JAX package's numpy modules, so the results are exact: the devkit
protocol (``nusc_official_metrics``), the quick metrics (``nusc_map_nds``)
and ``gts_from_infos`` on 9-column velocity boxes, the results json with
and without calibration, ``NuScenesDataset.evaluation``'s 3-tuple, and the
evaluator's path to it from a double-flip batch of B x 4 rows.
"""

import copy
import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
           "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone")


def _infos(rng, n=5, calib=True):
    infos = []
    for i in range(n):
        m = rng.randint(4, 12)
        b = np.zeros((m, 9), np.float32)
        b[:, :2] = rng.uniform(-45, 45, (m, 2))
        b[:, 2] = rng.uniform(-1.5, 0.5, m)
        b[:, 3:6] = rng.uniform(0.4, 6.0, (m, 3))
        b[:, 6:8] = rng.randn(m, 2)
        b[:, 8] = rng.uniform(-np.pi, np.pi, m)
        names = np.asarray(CLASSES)[rng.randint(0, 10, m)]
        names[0] = "ignore"   # not a detection class: dropped from the gts
        info = {"token": f"s{i}", "gt_boxes": b, "gt_names": names,
                "lidar_path": f"s{i}.bin", "sweeps": []}
        if calib:
            yaw = rng.uniform(-np.pi, np.pi)
            info.update(
                lidar2ego_rotation=[np.cos(0.7), 0.0, 0.0, np.sin(0.7)],
                lidar2ego_translation=[0.9, 0.0, 1.8],
                ego2global_rotation=[np.cos(yaw / 2), 0.0, 0.0,
                                     np.sin(yaw / 2)],
                ego2global_translation=list(rng.uniform(-900, 900, 3)))
        infos.append(info)
    return infos


def _detections(rng, infos):
    """Per sample the gt boxes moved a little (some beyond the 4 m
    threshold), some of them dropped, and false positives, scored at
    random, with labels from the names (misclassified now and then)."""
    dets = {}
    for info in infos:
        b = info["gt_boxes"]
        keep = rng.rand(len(b)) < 0.8
        d = b[keep].copy()
        d[:, :2] += rng.randn(len(d), 2) * rng.choice([0.2, 1.5, 5.0],
                                                      (len(d), 1))
        d[:, 3:6] *= rng.uniform(0.8, 1.2, (len(d), 3))
        d[:, 6:8] += rng.randn(len(d), 2) * 0.5
        d[:, 8] += rng.randn(len(d)) * 0.3
        lab = np.array([CLASSES.index(n) if n in CLASSES else 0
                        for n in info["gt_names"][keep]])
        flip = rng.rand(len(lab)) < 0.1
        lab[flip] = rng.randint(0, 10, int(flip.sum()))
        fp = np.zeros((3, 9), np.float32)
        fp[:, :2] = rng.uniform(-50, 50, (3, 2))
        fp[:, 3:6] = 1.0
        d = np.concatenate([d, fp]).astype(np.float32)
        lab = np.concatenate([lab, rng.randint(0, 10, 3)]).astype(np.int32)
        dets[info["token"]] = {"box3d_lidar": d,
                               "scores": rng.rand(len(d)).astype(np.float32),
                               "label_preds": lab, "metadata": {
                                   "token": info["token"]}}
    return dets


def _assert_tree_equal(got, want, path=""):
    assert type(got) is type(want) or (
        np.isscalar(got) and np.isscalar(want)), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_jax(seed):
    from partner_tpu.eval import detection_metrics as jdm
    from partner_tpu.eval import nusc_protocol as jnp_
    from partner_tpu_torch.eval import detection_metrics as tdm
    from partner_tpu_torch.eval import nusc_protocol as tnp_

    rng = np.random.RandomState(seed)
    infos = _infos(rng)
    dets = _detections(rng, infos)
    classes = list(CLASSES)
    gts = tdm.gts_from_infos(infos, classes)
    _assert_tree_equal(gts, jdm.gts_from_infos(infos, classes))
    assert all(g["gt_boxes"].shape[1] == 9 for g in gts.values())
    assert sum(len(g["gt_boxes"]) for g in gts.values()) == sum(
        len(i["gt_boxes"]) - 1 for i in infos)
    official = tnp_.nusc_official_metrics(dets, gts, classes)
    _assert_tree_equal(official, jnp_.nusc_official_metrics(dets, gts,
                                                            classes))
    assert 0 < official["mAP"] < 1 and 0 < official["NDS"] < 1
    assert np.isfinite(official["mAVE"])
    _assert_tree_equal(tdm.nusc_map_nds(dets, gts, classes),
                       jdm.nusc_map_nds(dets, gts, classes))


@pytest.mark.parametrize("calib", [True, False], ids=["global", "lidar"])
def test_results_json_equal_jax(tmp_path, calib):
    from partner_tpu.eval import nuscenes as jn
    from partner_tpu_torch.eval import nuscenes as tn

    rng = np.random.RandomState(4)
    infos = _infos(rng, calib=calib)
    dets = _detections(rng, infos)
    tp = tn.write_nusc_results(dets, infos, str(tmp_path / "t"), CLASSES)
    jp = jn.write_nusc_results(dets, infos, str(tmp_path / "j"), CLASSES)
    assert os.path.basename(tp) == "results_nusc.json"
    with open(tp) as f, open(jp) as g:
        t, j = json.load(f), json.load(g)
    assert t == j
    first = t["results"]["s0"][0]
    assert sorted(first) == sorted(
        ["sample_token", "translation", "size", "rotation", "velocity",
         "detection_name", "detection_score", "attribute_name"])
    box = dets["s0"]["box3d_lidar"][0]
    moved = not np.allclose(first["translation"], box[:3], atol=1e-3)
    assert moved == calib
    # the quaternion helpers one by one
    a, b = tn._yaw_to_quaternion(0.4), tn._yaw_to_quaternion(-1.1)
    np.testing.assert_array_equal(a, jn._yaw_to_quaternion(0.4))
    q = tn._quat_mult(a, b)
    np.testing.assert_array_equal(q, jn._quat_mult(a, b))
    v = rng.randn(3)
    np.testing.assert_array_equal(tn._quat_rotate(q, v),
                                  jn._quat_rotate(q, v))


def _datasets(tmp_path, infos):
    import partner_tpu.data as jdata
    import partner_tpu_torch.data as tdata

    path = str(tmp_path / "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    cfg = dict(type="NuScenesDataset", root_path=str(tmp_path),
               info_path=path, class_names=list(CLASSES), pipeline=[],
               nsweeps=10, mode="val")
    return (jdata.build_dataset(copy.deepcopy(cfg)),
            tdata.build_dataset(copy.deepcopy(cfg)))


def test_dataset_evaluation_equal_jax(tmp_path):
    """The 3-tuple (det metrics, seg mIoU, panoptic) with the json's path
    among the det metrics; a test set writes the json and computes
    nothing; seg and panoptic inputs (once a raise in the port) give
    JAX's mIoU and PQ / SQ / RQ exactly."""
    rng = np.random.RandomState(6)
    infos = _infos(rng)
    dets = _detections(rng, infos)
    jds, tds = _datasets(tmp_path, infos)
    got = tds.evaluation(dets, output_dir=str(tmp_path / "t"))
    want = jds.evaluation(dets, output_dir=str(tmp_path / "j"))
    assert len(got) == len(want) == 3 and got[1:] == want[1:] == (None, None)
    assert got[0].pop("results_path") == str(tmp_path / "t" /
                                             "results_nusc.json")
    want[0].pop("results_path")
    _assert_tree_equal(got[0], want[0])
    assert {"mAP", "NDS", "greedy/mAP"} <= set(got[0])
    assert tds.evaluation(dets, str(tmp_path / "ts"), testset=True) == (
        None, None, None)
    assert os.path.exists(tmp_path / "ts" / "results_nusc.json")
    final_seg, final_ins = {}, {}
    for i, token in enumerate(sorted(dets)[:3]):
        gt = rng.randint(0, 17, 3000)
        pred = np.where(rng.rand(3000) < 0.6, gt, rng.randint(0, 17, 3000))
        final_seg[token] = {"pred": pred, "gt": gt}
        inst = rng.randint(0, 3, 3000)
        final_ins[token] = {"pred_sem": pred, "gt_sem": gt, "gt_inst": inst,
                            "pred_inst": np.where(rng.rand(3000) < 0.8, inst,
                                                  rng.randint(0, 4, 3000))}
    got = tds.evaluation(dets, str(tmp_path / "s"), final_seg=final_seg,
                         final_ins=final_ins)
    want = jds.evaluation(dets, str(tmp_path / "js"), final_seg=final_seg,
                          final_ins=final_ins)
    assert got[1:] == want[1:] and 0 < got[1] < 1
    assert sorted(got[2]) == ["PQ", "RQ", "SQ"] and 0 < got[2]["PQ"] < 1


class _FlipDetector:
    """A stand-in detector on the double-flip contract: ``predict`` takes
    B x 4 rows and returns B rows, each sample's detections the boxes
    planted in its original (first) row's points."""

    input_kind = "points"

    def __init__(self, dets_by_row0):
        self.dets = dets_by_row0
        self.rows = []

    def predict(self, ex):
        pts = ex["points"].numpy()
        self.rows.append(len(pts))
        outs = [self.dets[int(pts[4 * i, 0, 4])]
                for i in range(len(pts) // 4)]
        n = max(len(d["scores"]) for d in outs)
        out = {"box3d_lidar": np.zeros((len(outs), n, 9), np.float32),
               "scores": np.zeros((len(outs), n), np.float32),
               "label_preds": np.zeros((len(outs), n), np.int32),
               "mask": np.zeros((len(outs), n), bool)}
        for i, d in enumerate(outs):
            k = len(d["scores"])
            out["box3d_lidar"][i, :k] = d["box3d_lidar"]
            out["scores"][i, :k] = d["scores"]
            out["label_preds"][i, :k] = d["label_preds"]
            out["mask"][i, :k] = True
        return {k: torch.from_numpy(v) for k, v in out.items()}


def test_evaluator_reads_a_flip_batch_per_sample(tmp_path):
    """``eval.evaluator.evaluate`` over the flip config's val pipeline at
    batch 2 (8 point rows a batch): each sample's detections land under
    its own token, and the dataset's evaluation gets what JAX's gets."""
    from partner_tpu_torch.data.pipeline import DoubleFlip, Reformat
    from partner_tpu_torch.eval.evaluator import evaluate

    rng = np.random.RandomState(8)
    infos = _infos(rng, n=4)
    for i, info in enumerate(infos):
        pts = rng.uniform(-40, 40, (300, 5)).astype(np.float32)
        pts[:, 4] = i   # which sample a row is, for the stand-in
        info["points"] = pts
    dets = _detections(rng, infos)
    _, tds = _datasets(tmp_path, infos)
    tds.pipeline.transforms = [
        lambda res, info: (dict(res, lidar=dict(res["lidar"],
                                                points=info["points"])),
                           info),
        DoubleFlip(), Reformat(double_flip=True)]
    det = _FlipDetector({i: dets[info["token"]]
                         for i, info in enumerate(infos)})
    logger = logging.getLogger("nusc-eval-test")
    (metrics, seg, pan), _ = evaluate(det, tds, str(tmp_path), logger, "cpu",
                                      batch_size=2, max_points=400)
    assert det.rows == [8, 8] and seg is None and pan is None
    with open(tmp_path / "prediction.pkl", "rb") as f:
        pred = pickle.load(f)
    assert sorted(pred) == sorted(dets)
    for token, d in dets.items():
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(pred[token][k], d[k])
    jds, _ = _datasets(tmp_path, infos)
    want = jds.evaluation(dets, output_dir=str(tmp_path / "j"))[0]
    metrics.pop("results_path")
    want.pop("results_path")
    _assert_tree_equal(metrics, want)
