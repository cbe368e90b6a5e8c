"""The port's host tools against the JAX package's (CPU): the NMS
ensemble, panoptic instance ids, the PLY scene and the demo's BEV corners,
all equal to JAX's on seeded inputs; the demo CLI's PNG; and the card-side
CLIs' refusal to fall back to the CPU."""

import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)

torch.set_num_threads(2)


def predictions(rng, n_tokens=4, n=40, labels=3):
    """One model's predictions: clustered boxes (so NMS has overlaps to
    resolve) of several classes, 7 or 9 columns."""
    out = {}
    for t in range(n_tokens):
        centers = rng.uniform(-30, 30, (n // 4, 2))
        b = np.zeros((n, 9 if t % 2 else 7), np.float32)
        b[:, :2] = np.repeat(centers, 4, 0) + rng.randn(n, 2) * 0.6
        b[:, 2] = rng.randn(n)
        b[:, 3:6] = rng.uniform(1, 5, (n, 3))
        b[:, -1] = rng.uniform(-np.pi, np.pi, n)
        out[f"tok{t}"] = {"box3d_lidar": b,
                          "scores": rng.rand(n).astype(np.float32),
                          "label_preds": rng.randint(0, labels, n)}
    return out


def test_ensemble_matches_jax(rng):
    import nms_ensemble

    from partner_tpu_torch.tools import nms_ensemble as pens

    a, b = predictions(rng), predictions(rng)
    b["tok_only_b"] = predictions(rng, 1)["tok0"]
    b["tok_empty"] = {"box3d_lidar": np.zeros((0, 7), np.float32),
                      "scores": np.zeros(0, np.float32),
                      "label_preds": np.zeros(0, np.int64)}
    for kw in ({}, {"weights": [1.0, 0.8], "iou": 0.3, "post": 12}):
        want = nms_ensemble.ensemble([a, b], **kw)
        got = pens.ensemble([a, b], **kw, device="cpu")
        assert sorted(got) == sorted(want)
        kept = 0
        for tok in want:
            for k in ("box3d_lidar", "scores", "label_preds"):
                np.testing.assert_array_equal(got[tok][k], want[tok][k],
                                              err_msg=f"{tok} {k}")
            kept += len(want[tok]["scores"])
        assert 0 < kept < sum(len(p[t]["scores"]) for p in (a, b) for t in p)


def test_instance_ids_match_jax(rng, tmp_path):
    import generate_instance_ids as gii

    from partner_tpu_torch.tools import generate_instance_ids as pgii

    infos = []
    for t in range(3):
        boxes = np.zeros((6, 9), np.float32)
        boxes[:, :2] = rng.uniform(-10, 10, (6, 2))
        boxes[1, :2] = boxes[0, :2] + 0.5          # two boxes overlap
        boxes[:, 3:6] = rng.uniform(1, 4, (6, 3))
        boxes[:, -1] = rng.uniform(-np.pi, np.pi, 6)
        pts = np.concatenate([rng.uniform(-12, 12, (3000, 2)),
                              rng.uniform(-2, 2, (3000, 1)),
                              rng.rand(3000, 2)], 1).astype(np.float32)
        labels = rng.randint(0, 14, 3000)
        things = [1, 2, 3, 5, 8]
        want = gii.instance_ids_for_frame(pts[:, :3], labels, boxes, things)
        got = pgii.instance_ids_for_frame(pts[:, :3], labels, boxes, things)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and len(set(got)) > 3
        infos.append({"token": f"t{t}", "points": pts,
                      "points_label": labels, "gt_boxes": boxes})
    infos.append({"token": "empty", "points": pts[:10]})
    info_p = str(tmp_path / "infos.pkl")
    with open(info_p, "wb") as f:
        pickle.dump(infos, f)
    out = pgii.main(["--info_path", info_p, "--out",
                     str(tmp_path / "ids.pkl")])
    assert sorted(out) == ["empty", "t0", "t1", "t2"]
    assert not out["empty"].any()
    for info in infos[:3]:
        np.testing.assert_array_equal(out[info["token"]],
                                      gii.instance_ids_for_frame(
                                          info["points"][:, :3],
                                          info["points_label"],
                                          info["gt_boxes"],
                                          list(range(1, 11))))


def scene(rng):
    pts = np.concatenate([rng.uniform(-40, 40, (500, 2)),
                          rng.uniform(-2, 3, (500, 1)),
                          rng.rand(500, 2)], 1).astype(np.float32)
    det = np.zeros((5, 9), np.float32)
    det[:, :3] = rng.uniform(-20, 20, (5, 3))
    det[:, 3:6] = rng.uniform(1, 5, (5, 3))
    det[:, -1] = rng.uniform(-np.pi, np.pi, 5)
    gt = det[:3, [0, 1, 2, 3, 4, 5, 8]] + 0.2
    return pts, det, gt


def test_ply_scene_and_bev_corners_match_jax(rng, tmp_path):
    from partner_tpu.utils import viz3d as jviz
    import demo

    from partner_tpu_torch.tools import demo as pdemo
    from partner_tpu_torch.utils import viz3d as pviz

    pts, det, gt = scene(rng)
    for name, args in (("all", (pts, det, gt)), ("xyz", (pts[:, :3], det,
                                                         None)),
                       ("none", (pts, None, np.zeros((0, 7))))):
        want = jviz.write_ply_scene(str(tmp_path / f"j_{name}.ply"), *args)
        got = pviz.write_ply_scene(str(tmp_path / f"p_{name}.ply"), *args)
        with open(want, "rb") as f1, open(got, "rb") as f2:
            assert f2.read() == f1.read(), name
    np.testing.assert_array_equal(pviz.box_corners_3d(det),
                                  jviz.box_corners_3d(det))
    for boxes in (det, gt, np.zeros((0, 7))):
        np.testing.assert_array_equal(pdemo.box_corners_bev(boxes),
                                      demo.box_corners_bev(boxes))
    if importlib.util.find_spec("open3d") is None:
        with pytest.raises(ImportError, match="open3d"):
            pviz.to_open3d(pts, det, gt)


def test_demo_cli(rng, tmp_path, monkeypatch):
    """The demo writes a PNG (and a PLY) a frame on this host; without
    matplotlib it exits non-zero naming it."""
    from partner_tpu_torch.tools import demo as pdemo

    pts, det, gt = scene(rng)
    frame_p = str(tmp_path / "frame.pkl")
    with open(frame_p, "wb") as f:
        pickle.dump({"lidars": {"points_xyz": pts[:, :3],
                                "points_feature": pts[:, 3:]}}, f)
    infos = [{"token": "a", "points": pts, "gt_boxes": gt},
             {"token": "b", "path": frame_p}]
    preds = {t: {"box3d_lidar": det, "scores": np.linspace(0.1, 0.9, 5)}
             for t in ("a", "b")}
    paths = {}
    for name, obj in (("pred", preds), ("infos", infos)):
        paths[name] = str(tmp_path / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(obj, f)
    argv = ["--prediction", paths["pred"], "--info_path", paths["infos"],
            "--out_dir", str(tmp_path / "out"), "--export_ply"]
    if importlib.util.find_spec("matplotlib") is not None:
        written = pdemo.main(argv)
        assert [os.path.basename(p) for p in written] == [
            "a.png", "a.ply", "b.png", "b.ply"]
        with open(written[0], "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "matplotlib"
                        else real(n, *a))
    with pytest.raises(SystemExit) as e:
        pdemo.main(argv)
    assert "matplotlib" in str(e.value.code)


def test_card_side_clis_refuse_the_cpu_without_the_flag(rng, tmp_path,
                                                        monkeypatch):
    """With no card and no ``--device cpu``, ``nms_ensemble`` and
    ``flops_report`` exit non-zero; with ``--device cpu`` the ensemble
    runs and writes what ``ensemble`` returns."""
    from partner_tpu_torch.tools import flops_report
    from partner_tpu_torch.tools import nms_ensemble as pens

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pred = str(tmp_path / "a.pkl")
    preds = predictions(rng)
    with open(pred, "wb") as f:
        pickle.dump(preds, f)
    out = str(tmp_path / "out.pkl")
    for main, argv in ((pens.main, [out, pred]), (flops_report.main, [])):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert "no CUDA device" in str(e.value.code)
    merged = pens.main([out, pred, pred, "--weights", "1.0", "0.5",
                        "--device", "cpu"])
    with open(out, "rb") as f:
        written = pickle.load(f)
    with pytest.raises(TypeError):     # no default device: the caller names it
        pens.ensemble([preds, preds], [1.0, 0.5])
    want = pens.ensemble([preds, preds], [1.0, 0.5], device="cpu")
    for tok in want:
        for k in want[tok]:
            np.testing.assert_array_equal(written[tok][k], want[tok][k])
            np.testing.assert_array_equal(merged[tok][k], want[tok][k])
