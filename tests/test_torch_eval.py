"""Detection metrics: partner_tpu_torch.eval against partner_tpu.eval.

The port keeps its own copies of the JAX package's numpy metric modules;
on seeded detections and ground truths (three classes, jittered true
positives, false positives, difficulty levels and point counts) every
metric dict must equal JAX's exactly, and the devkit writer must write the
same bytes.
"""

import numpy as np
import pytest

CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]


def seeded(seed, n_frames=5):
    """(infos, detections): gts per frame, and detections that hit some
    of them (jittered) among false positives."""
    rng = np.random.RandomState(seed)
    infos, dets = [], {}
    for fi in range(n_frames):
        ng = rng.randint(0, 12)
        rho, phi = rng.uniform(3, 70, ng), rng.uniform(-np.pi, np.pi, ng)
        gt = np.zeros((ng, 9), np.float32)
        gt[:, 0], gt[:, 1] = rho * np.cos(phi), rho * np.sin(phi)
        gt[:, 2] = rng.uniform(-0.5, 0.5, ng)
        gt[:, 3:6] = rng.uniform(0.8, 5.0, (ng, 3))
        gt[:, -1] = rng.uniform(-np.pi, np.pi, ng)
        cls = rng.randint(0, 3, ng)
        token = f"seg_{fi // 2}_frame_{fi}"
        infos.append({
            "token": token, "gt_boxes": gt,
            "gt_names": np.array([CLASSES[c] for c in cls], dtype="<U10"),
            "num_points_in_gt": rng.randint(0, 40, ng).astype(np.int32),
            "difficulty": rng.randint(0, 3, ng).astype(np.int32),
            "frame_name": f"seg_{fi // 2}_frame_{1000 + fi}",
        })
        hit = rng.rand(ng) < 0.7
        tp = gt[hit][:, [0, 1, 2, 3, 4, 5, 8]].copy()
        tp[:, :3] += rng.normal(0, 0.2, (len(tp), 3))
        tp[:, 6] += rng.normal(0, 0.3, len(tp))
        nf = rng.randint(0, 6)
        fp = np.concatenate([rng.uniform(-60, 60, (nf, 3)),
                             rng.uniform(0.8, 5.0, (nf, 3)),
                             rng.uniform(-np.pi, np.pi, (nf, 1))], 1)
        boxes = np.concatenate([tp, fp]).astype(np.float32)
        dets[token] = {
            "box3d_lidar": boxes,
            "scores": rng.rand(len(boxes)).astype(np.float32),
            "label_preds": np.concatenate([cls[hit], rng.randint(0, 3, nf)]),
            "metadata": {"token": token},
        }
    return infos, dets


def assert_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    from partner_tpu.eval import detection_metrics as jdm
    from partner_tpu.eval import waymo_protocol as jwp
    from partner_tpu_torch.eval import detection_metrics as tdm
    from partner_tpu_torch.eval import waymo_protocol as twp

    infos, dets = seeded(seed)
    jg, tg = jdm.gts_from_infos(infos, CLASSES), tdm.gts_from_infos(
        infos, CLASSES)
    assert sorted(tg) == sorted(jg)
    for token in jg:
        assert sorted(tg[token]) == sorted(jg[token])
        for k in jg[token]:
            np.testing.assert_array_equal(tg[token][k], jg[token][k])
    jm = jwp.waymo_official_metrics(dets, jg, CLASSES)
    assert_dicts_equal(twp.waymo_official_metrics(dets, tg, CLASSES), jm)
    assert 0 < jm["mAP/L1"] < 1          # the seeded set is not trivial
    assert_dicts_equal(tdm.waymo_ap_aph(dets, tg, CLASSES),
                       jdm.waymo_ap_aph(dets, jg, CLASSES))
    token = next(t for t in dets if len(dets[t]["box3d_lidar"]))
    b = dets[token]["box3d_lidar"]
    np.testing.assert_array_equal(tdm.bev_iou_matrix(b, b[::-1]),
                                  jdm.bev_iou_matrix(b, b[::-1]))


def test_waymo_evaluation_and_writer_equal_jax(tmp_path):
    """``WaymoDataset.evaluation`` on both sides: the same metric dict and
    the same ``detection_pred.bin`` bytes."""
    import pickle

    import partner_tpu.data as jdata
    import partner_tpu_torch.data as tdata

    infos, dets = seeded(5)
    path = str(tmp_path / "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    out = {}
    for name, pkg in (("jax", jdata), ("port", tdata)):
        ds = pkg.build_dataset(dict(type="WaymoDataset", root_path="",
                                    info_path=path, class_names=CLASSES,
                                    mode="val"))
        wd = tmp_path / name
        metrics, _ = ds.evaluation(dets, output_dir=str(wd))
        with open(wd / "detection_pred.bin", "rb") as f:
            out[name] = (metrics, f.read())
    assert_dicts_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1] and len(out["jax"][1]) > 100
