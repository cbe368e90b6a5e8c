"""The port's serving entry points against the JAX package's tools (CPU).

From one JAX checkpoint of randomized weights, both packages' tools run in
this process on the same inputs, made from a seed:

- ``dist_test --input voxels`` (the evaluator's voxel ``predict``) against
  ``tools/dist_test.py --input voxels``, on the tiny flagship cut;
- ``single_inference``: ``run_frame`` and ``--once`` (``.det.npz`` beside
  each frame file) against ``tools/single_inference.py``, on the tiny
  flagship cut;
- ``multi_sweep_inference --nsweeps 2`` (``prediction.pkl``) against
  ``tools/multi_sweep_inference.py``, on the tiny two-sweep velocity
  CenterPoint cut.

Kept boxes: labels and count exact, boxes and scores to 1e-4 (float32 on
both sides, another summation order). Each port tool's detections are
bit-equal to the port detector's direct ``predict`` of the same buffers.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from test_data_pipeline import make_waymo_infos
from torch_port_fixtures import (CENTERPOINT_VELO, randomize,
                                 tiny_centerpoint_cfg, tiny_frame_cfg,
                                 write_three_class_infos,
                                 write_tiny_centerpoint_config,
                                 write_tiny_eval_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
MAX_POINTS = 5000
# the tiny cuts hold a few thousand points: a smaller voxel capacity keeps
# the stem and the scatter at a CPU size (both packages read it)
CAPACITY = "voxel_generator['max_voxel_num'] = [3000, 4000]\n"


def jax_tool(name):
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import importlib

    return importlib.import_module(name)


def run_jax_main(module, argv):
    old = sys.argv
    try:
        sys.argv = [module.__name__ + ".py"] + argv
        return module.main()
    finally:
        sys.argv = old


def save_jax_checkpoint(path, model_cfg, test_cfg, c, rng):
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint

    z = np.zeros((1, 64, c), np.float32)
    v = randomize(jax_build(model_cfg, None, test_cfg).init(
        jax.random.PRNGKey(0), {"points": z,
                                "points_mask": np.zeros((1, 64), bool)}),
        rng)

    class State:   # what save_checkpoint reads of a TrainState
        step, params, batch_stats, opt_state = 0, v["params"], \
            v["batch_stats"], {}

    save_checkpoint(path, State)
    return os.path.join(path, "latest")


def assert_same_boxes(got, want, token=""):
    assert len(got["scores"]) == len(want["scores"]) > 5, token
    np.testing.assert_array_equal(got["label_preds"], want["label_preds"],
                                  err_msg=token)
    np.testing.assert_allclose(got["box3d_lidar"], want["box3d_lidar"],
                               rtol=0, atol=1e-4, err_msg=token)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-4, err_msg=token)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The tiny flagship cut as a config file (voxel capacity cut), its
    val infos and a JAX checkpoint of randomized weights."""
    tmp = tmp_path_factory.mktemp("serving")
    info_path = make_waymo_infos(tmp, n=3, seed=7)
    cfg_path = write_tiny_eval_config(str(tmp / "cfg.py"), info_path,
                                      str(tmp))
    with open(cfg_path, "a") as f:
        f.write(CAPACITY)
    m, tc = tiny_frame_cfg()
    ckpt = save_jax_checkpoint(str(tmp / "ckpt"), m, tc, 7,
                               np.random.RandomState(7))
    return tmp, cfg_path, info_path, ckpt


def test_dist_test_voxel_input_matches_jax(flagship):
    from partner_tpu_torch.tools import dist_test

    tmp, cfg_path, _, ckpt = flagship
    common = ["--max_points", str(MAX_POINTS), "--checkpoint", ckpt,
              "--input", "voxels"]
    jax_metrics, _ = run_jax_main(jax_tool("dist_test"), [
        cfg_path, "--work_dir", str(tmp / "jax_eval")] + common)
    (metrics, _), fps = dist_test.main([
        cfg_path, "--device", "cpu", "--work_dir", str(tmp / "port_eval")]
        + common)
    assert fps > 0 and sorted(metrics) == sorted(jax_metrics)
    for k in jax_metrics:
        assert abs(metrics[k] - jax_metrics[k]) <= 1e-6, k
    preds = []
    for d in ("jax_eval", "port_eval"):
        with open(tmp / d / "prediction.pkl", "rb") as f:
            preds.append(pickle.load(f))
    jp, tp = preds
    assert sorted(tp) == sorted(jp) == ["frame0", "frame1", "frame2"]
    for token in jp:
        assert_same_boxes(tp[token], jp[token], token)
    # the static-RPE cache filled from the voxel contract's example
    dist_test.main([cfg_path, "--device", "cpu", "--static_rpe",
                    "--work_dir", str(tmp / "port_static")] + common)
    with open(tmp / "port_static" / "prediction.pkl", "rb") as f:
        sp = pickle.load(f)
    for token in tp:
        assert_same_boxes(sp[token], tp[token], token)


@pytest.fixture(scope="module")
def jax_single(flagship):
    """The JAX tool's predictor (variables, jitted predict, meta), built
    once for this module's tests."""
    from partner_tpu.train.config import Config

    _, cfg_path, _, ckpt = flagship
    return jax_tool("single_inference").build_predictor(
        Config.fromfile(cfg_path), ckpt, max_points=MAX_POINTS)


def _frame(rng, n=3000):
    r = rng.uniform(1, 34, n)
    th = rng.uniform(-np.pi, np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th),
                     rng.uniform(-1.5, 2.5, n), rng.rand(n), rng.rand(n)],
                    1).astype(np.float32)


def test_single_inference_matches_jax_and_direct_predict(flagship,
                                                         jax_single):
    from partner_tpu_torch.tools import single_inference as tsi
    from partner_tpu_torch.utils.config import load_config

    _, cfg_path, _, ckpt = flagship
    jsi = jax_tool("single_inference")
    pts = _frame(np.random.RandomState(8))
    variables, jpredict, jmeta = jax_single
    want = jsi.run_frame(variables, jpredict, jmeta, pts,
                         score_threshold=0.0)
    det, predict, meta = tsi.build_predictor(load_config(cfg_path), ckpt,
                                             MAX_POINTS, device="cpu")
    got = tsi.run_frame(predict, meta, pts, score_threshold=0.0)
    assert got["time"] > 0
    assert_same_boxes(got, want)
    # the tool computes what the detector's predict does on its buffers
    from partner_tpu_torch.core import box_np_ops
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    feats = box_np_ops.transform_points(pts, "cylinder")[:, :7]
    buf = np.zeros((1, MAX_POINTS, 7), np.float32)
    buf[0, :len(feats)] = feats
    mask = np.zeros((1, MAX_POINTS), bool)
    mask[0, :len(feats)] = True
    cfg = load_config(cfg_path)
    vox = DeviceVoxelizer(cfg["voxel_generator"], "cpu", 3000)
    direct = det.predict(vox(torch.from_numpy(buf), torch.from_numpy(mask)))
    m = direct["mask"][0].numpy()
    for k in ("box3d_lidar", "scores", "label_preds"):
        np.testing.assert_array_equal(got[k], direct[k][0].numpy()[m],
                                      err_msg=k)


def test_single_inference_once_writes_detections(flagship, jax_single,
                                                 tmp_path, monkeypatch):
    from partner_tpu.train.config import Config
    from partner_tpu_torch.tools import single_inference as tsi

    _, cfg_path, _, ckpt = flagship
    jsi = jax_tool("single_inference")
    # the JAX file loop with its predictor built once for the module
    monkeypatch.setattr(jsi, "build_predictor", lambda *a: jax_single)
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        rng = np.random.RandomState(9)
        _frame(rng).tofile(str(tmp_path / side / "f0.bin"))
        np.save(str(tmp_path / side / "f1.npy"), _frame(rng)[:, :4])

    class A:
        watch_dir = str(tmp_path / "jax")
        once, poll, checkpoint, score, max_points = (True, 0.01, ckpt, 0.0,
                                                     MAX_POINTS)

    jsi._file_loop(A, Config.fromfile(cfg_path))
    tsi.main([cfg_path, "--once", "--watch_dir", str(tmp_path / "port"),
              "--checkpoint", ckpt, "--score", "0.0", "--max_points",
              str(MAX_POINTS), "--device", "cpu"])
    for name in ("f0", "f1"):
        want = np.load(tmp_path / "jax" / f"{name}.det.npz")
        got = np.load(tmp_path / "port" / f"{name}.det.npz")
        assert sorted(got.files) == sorted(want.files) == [
            "box3d_lidar", "label_preds", "scores"]
        assert_same_boxes(got, want, name)


def test_single_inference_without_a_card_or_rospy_exits(flagship):
    from partner_tpu_torch.tools import single_inference as tsi

    _, cfg_path, _, _ = flagship
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tsi.main([cfg_path, "--once"])
    with pytest.raises(SystemExit, match="rospy"):
        tsi.main([cfg_path, "--ros", "--device", "cpu"])


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Four timed frames with ego poses (a drive along a curve) for the
    tiny two-sweep velocity CenterPoint cut, and a JAX checkpoint."""
    tmp = tmp_path_factory.mktemp("sweeps")
    rng = np.random.RandomState(10)
    info_path = write_three_class_infos(str(tmp / "infos.pkl"), rng, n=4,
                                        n_points=(2000, 2500))
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    for i, info in enumerate(infos[::-1]):   # written out of time order
        yaw = 0.05 * i
        pose = np.eye(4)
        pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]]
        pose[:3, 3] = [1.5 * i, 0.2 * i, 0.01 * i]
        info.update(pose=pose, timestamp=1.0e6 + 0.1 * i)
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    cfg_path = write_tiny_centerpoint_config(
        str(tmp / "cfg.py"), info_path, info_path, str(tmp),
        config=CENTERPOINT_VELO)
    with open(cfg_path, "a") as f:
        f.write(CAPACITY)
    m, tc = tiny_centerpoint_cfg(CENTERPOINT_VELO)
    ckpt = save_jax_checkpoint(str(tmp / "ckpt"), m, tc, 8, rng)
    return tmp, cfg_path, info_path, ckpt


def test_multi_sweep_inference_matches_jax_and_direct_predict(sweeps):
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.tools import multi_sweep_inference as tmsi
    from partner_tpu_torch.tools.single_inference import build_predictor
    from partner_tpu_torch.utils.config import load_config

    tmp, cfg_path, info_path, ckpt = sweeps
    common = ["--info_path", info_path, "--checkpoint", ckpt, "--nsweeps",
              "2", "--max_points", str(MAX_POINTS)]
    run_jax_main(jax_tool("multi_sweep_inference"), [
        cfg_path, "--work_dir", str(tmp / "jax")] + common)
    dets, fps = tmsi.main([cfg_path, "--work_dir", str(tmp / "port"),
                           "--device", "cpu"] + common)
    assert fps > 0
    preds = []
    for d in ("jax", "port"):
        with open(tmp / d / "prediction.pkl", "rb") as f:
            preds.append(pickle.load(f))
    jp, tp = preds
    assert sorted(tp) == sorted(jp) == sorted(dets) and len(tp) == 4
    for token in jp:
        assert tp[token]["box3d_lidar"].shape[1] == 9     # velocity
        assert_same_boxes(tp[token], jp[token], token)
    # the last frame again, by hand: its two sweeps in its ego frame, then
    # the detector's direct predict of that buffer
    with open(info_path, "rb") as f:
        infos = sorted(pickle.load(f), key=lambda i: i["timestamp"])
    kept = [(i["points"], i["pose"], i["timestamp"]) for i in infos[-2:]]
    feats = tmsi.frame_points(kept, infos[-1]["pose"],
                              infos[-1]["timestamp"], "cylinder", 8)
    assert len(feats) == sum(len(i["points"]) for i in infos[-2:])
    assert set(np.unique(feats[:, 7])) == {0.0, np.float32(
        infos[-1]["timestamp"] - infos[-2]["timestamp"])}
    cfg = load_config(cfg_path)
    det, _, _ = build_predictor(cfg, ckpt, MAX_POINTS, device="cpu")
    buf = np.zeros((1, MAX_POINTS, 8), np.float32)
    buf[0, :len(feats)] = feats
    mask = np.zeros((1, MAX_POINTS), bool)
    mask[0, :len(feats)] = True
    vox = DeviceVoxelizer(cfg["voxel_generator"], "cpu", 3000)
    out = det.predict(vox(torch.from_numpy(buf), torch.from_numpy(mask)))
    m = out["mask"][0].numpy()
    for k in ("box3d_lidar", "scores", "label_preds"):
        np.testing.assert_array_equal(tp[infos[-1]["token"]][k],
                                      out[k][0].numpy()[m], err_msg=k)
