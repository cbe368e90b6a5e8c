"""The port's evaluation CLI against the JAX package's, from one checkpoint.

A tiny config file (the flagship config exec'd, cut to the tiny grid and
widths), synthetic Waymo val infos and a JAX checkpoint of randomized
weights; ``tools/dist_test.py`` (JAX) runs in this process and
``python -m partner_tpu_torch.tools.dist_test --device cpu`` in fresh
processes, which must import nothing of jax, flax, optax or
``partner_tpu``. The ground truths are placed on the detector's own boxes,
so the metrics are not all zero.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_data_pipeline import make_waymo_infos
from torch_port_fixtures import (randomize, tiny_frame_cfg,
                                 write_tiny_eval_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_POINTS = 5000
N_FRAMES = 4

_PORT_CLI = r"""
import json, sys
from partner_tpu_torch.tools import dist_test
(metrics, _), fps = dist_test.main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "fps": fps, "metrics": metrics}))
"""


def run_port(args):
    res = subprocess.run(
        [sys.executable] + args, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    return res


def load_pred(work_dir):
    with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
        return pickle.load(f)


def direct_predictions(cfg_path, ckpt):
    """The port's detector predicting each collated val batch directly."""
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import load_checkpoint
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(cfg_path)
    det = build_detector(cfg["model"], None, cfg["test_cfg"], device="cpu")
    det.module.load_state_dict(load_checkpoint(ckpt)[0]["state_dict"])
    out = {}
    ds = tdata.build_dataset(dict(cfg["data"]["val"]))
    for b in DataLoader(ds, 1, shuffle=False, max_points=MAX_POINTS):
        o = det.predict({k: torch.from_numpy(b[k])
                         for k in ("points", "points_mask")})
        m = o["mask"][0]
        out[b["metadata"][0]["token"]] = {
            k: o[k][0][m].numpy() for k in ("box3d_lidar", "scores",
                                            "label_preds")}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("dist_test")
    info_path = make_waymo_infos(tmp, n=N_FRAMES, seed=5)
    cfg_path = write_tiny_eval_config(str(tmp / "cfg.py"), info_path,
                                      str(tmp))
    model_cfg, test_cfg = tiny_frame_cfg()
    rng = np.random.RandomState(5)
    z = np.zeros((1, 64, 7), np.float32)
    v = randomize(jax_build(model_cfg, None, test_cfg).init(
        jax.random.PRNGKey(0), {"points": z,
                                "points_mask": np.zeros((1, 64), bool)}),
        rng)

    class State:   # what save_checkpoint reads of a TrainState
        step, params, batch_stats, opt_state = 0, v["params"], \
            v["batch_stats"], {}

    save_checkpoint(str(tmp / "ckpt"), State)
    ckpt = str(tmp / "ckpt" / "latest")

    # gts on some of the detector's own boxes, jittered, among misses
    direct = direct_predictions(cfg_path, ckpt)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    for info in infos:
        boxes = direct[info["token"]]["box3d_lidar"][::3][:8].copy()
        boxes[:, :3] += rng.normal(0, 0.15, (len(boxes), 3))
        boxes[:, 6] += rng.normal(0, 0.2, len(boxes))
        gt = np.concatenate([boxes[:, :6], np.zeros((len(boxes), 2)),
                             boxes[:, 6:7]], 1).astype(np.float32)
        info["gt_boxes"] = np.concatenate([gt, info["gt_boxes"]])
        info["gt_names"] = np.array(["Vehicle"] * len(info["gt_boxes"]))
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import dist_test as jax_dist_test

    common = ["--max_points", str(MAX_POINTS), "--checkpoint", ckpt]
    argv = sys.argv
    try:
        sys.argv = ["dist_test.py", cfg_path, "--work_dir",
                    str(tmp / "jax")] + common
        jax_metrics, _ = jax_dist_test.main()
    finally:
        sys.argv = argv
    port = run_port(["-c", _PORT_CLI, cfg_path, "--device", "cpu",
                     "--work_dir", str(tmp / "port")] + common)
    static = run_port(["-m", "partner_tpu_torch.tools.dist_test", cfg_path,
                       "--device", "cpu", "--static_rpe", "--work_dir",
                       str(tmp / "static")] + common)
    return dict(tmp=tmp, cfg=cfg_path, direct=direct,
                jax_metrics=jax_metrics, port=port, static=static)


def test_port_cli_imports_nothing_of_jax(runs):
    assert runs["port"].returncode == 0, runs["port"].stderr
    got = json.loads(runs["port"].stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["fps"] > 0


def test_predictions_match_jax_and_direct_predict(runs):
    tmp = runs["tmp"]
    jp, tp = load_pred(tmp / "jax"), load_pred(tmp / "port")
    assert sorted(tp) == sorted(jp) == [f"frame{i}" for i in range(N_FRAMES)]
    for token in jp:
        j, t, d = jp[token], tp[token], runs["direct"][token]
        assert len(t["scores"]) == len(j["scores"]) > 10, token
        np.testing.assert_array_equal(t["label_preds"], j["label_preds"])
        np.testing.assert_allclose(t["box3d_lidar"], j["box3d_lidar"],
                                   rtol=0, atol=1e-4, err_msg=token)
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=0,
                                   atol=1e-4, err_msg=token)
        # the entry point computes what predict does on the same batch
        for k in d:
            np.testing.assert_array_equal(t[k], d[k], err_msg=k)


def test_metrics_match_jax(runs):
    jm = runs["jax_metrics"]
    assert 0 < jm["mAP/L1"] and "mAPH/L2" in jm
    tm = json.loads(runs["port"].stdout.strip().splitlines()[-1])["metrics"]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-6, (k, tm[k], jm[k])


def test_static_rpe_gives_the_same_predictions(runs):
    assert runs["static"].returncode == 0, runs["static"].stderr
    assert "static-RPE cache: 2 tables" in runs["static"].stderr
    tp, sp = load_pred(runs["tmp"] / "port"), load_pred(runs["tmp"] /
                                                        "static")
    assert sorted(sp) == sorted(tp)
    for token in tp:
        np.testing.assert_array_equal(sp[token]["label_preds"],
                                      tp[token]["label_preds"])
        for k in ("box3d_lidar", "scores"):
            np.testing.assert_allclose(sp[token][k], tp[token][k], rtol=0,
                                       atol=1e-4, err_msg=k)


def test_no_card_without_device_cpu_fails(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    res = run_port(["-m", "partner_tpu_torch.tools.dist_test", runs["cfg"],
                    "--work_dir", str(runs["tmp"] / "nocard")])
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not os.path.exists(runs["tmp"] / "nocard" / "prediction.pkl")
