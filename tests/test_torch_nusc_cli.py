"""The nuScenes CenterPoint configs through the port's entry points (CPU).

Each of the three configs cut as ``tests/torch_port_fixtures.
write_tiny_nusc_config`` cuts them, over a synthetic nuScenes set written
as the loader reads it (``NUSC_SWEEPS`` sweeps a frame, infos from the
port's ``create_data nuscenes_data_prep``), from one JAX checkpoint:
``python -m partner_tpu_torch.tools.dist_test --device cpu`` in a fresh
process against ``tools/dist_test.py`` in this one (every frame's kept
boxes, the nuScenes metrics, the results json) for the DCN and flip
configs, and for the 01voxel config (whose frame
``tests/test_torch_nusc_frame.py`` holds against JAX) against the JAX
dataset's evaluation of the port's own detections; and two steps of
``python -m partner_tpu_torch.tools.train --device cpu`` (the DCN heads'
backward through the plain deformable conv), whose checkpoint loads back
strictly. The port's processes must import nothing of jax, flax, optax
or ``partner_tpu``. The double-flip config is evaluated at batch 2 (8
point rows a batch): at one sample the JAX package's jitted flip average
is wrong on the CPU (ROADMAP.md §3).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_fixtures import (NUSC_CONFIGS as CONFIGS, NUSC_SWEEPS,
                                 assert_same_detections, nusc_jax_variables,
                                 tiny_centerpoint_cfg, write_tiny_nusc_config,
                                 write_tiny_nusc_set)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_POINTS = 5000   # 3 sweeps of ~1,500 points: nothing is cut
JAX_CLI = ("dcn", "dcn-flip")   # the configs run through tools/dist_test.py

_PORT_DIST_TEST = r"""
import json, sys
from partner_tpu_torch.tools import dist_test
(metrics, seg, pan), fps = dist_test.main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "fps": fps, "metrics": metrics,
                  "rest": [seg, pan]}))
"""

_PORT_TRAIN = r"""
import json, sys
from partner_tpu_torch.tools import train
steps = train.main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "steps": steps}))
"""


def port(args):
    """A port entry point in a fresh process (started, not awaited)."""
    return subprocess.Popen(
        [sys.executable] + args, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc):
    out, err = proc.communicate(timeout=900)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run_jax_dist_test(argv):
    """``tools/dist_test.py`` main() in this process with ``argv``. The
    tool's random init, whose every leaf the checkpoint then replaces
    (it reads only the tree's structure), is traced for its shapes and
    not compiled: a flax init compiles ~15 s of threefry draws on the
    CPU."""
    import functools
    from unittest import mock

    import jax
    from partner_tpu.models.detectors import CenterPointDetector

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import dist_test

    def shapes_only(det, rng, example):
        return jax.eval_shape(functools.partial(det.module.init, train=False),
                              rng, example)

    old = sys.argv
    sys.argv = ["dist_test.py"] + argv
    try:
        with mock.patch.object(CenterPointDetector, "init", shapes_only):
            return dist_test.main()
    finally:
        sys.argv = old


def load_pred(work_dir):
    with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("nusc_cli")
    info = write_tiny_nusc_set(str(tmp), seed=5)
    procs, jax_results, paths = {}, {}, {}
    for name, config in CONFIGS.items():
        d = tmp / name
        d.mkdir()
        cfg = write_tiny_nusc_config(str(d / "cfg.py"), info, info, str(tmp),
                                     config)
        m, tc = tiny_centerpoint_cfg(config)
        v = nusc_jax_variables(jax_build(m, None, tc),
                               np.random.RandomState(7))

        class State:   # what save_checkpoint reads of a TrainState
            step, params, batch_stats, opt_state = 0, v["params"], \
                v["batch_stats"], {}

        save_checkpoint(str(d / "init"), State)
        ckpt = str(d / "init" / "latest")
        common = ["--max_points", str(MAX_POINTS), "--batch_size", "2"]
        procs[name, "dist_test"] = port(
            ["-c", _PORT_DIST_TEST, cfg, "--device", "cpu", "--checkpoint",
             ckpt, "--work_dir", str(d / "port_eval")] + common)
        procs[name, "train"] = port(
            ["-c", _PORT_TRAIN, cfg, "--device", "cpu", "--work_dir",
             str(d / "port_train"), "--total_steps", "2",
             "--max_steps_per_epoch", "2", "--load_from", ckpt] + common)
        paths[name] = (cfg, d)
    for name in JAX_CLI:
        cfg, d = paths[name]
        jax_results[name] = run_jax_dist_test(
            [cfg, "--checkpoint", str(d / "init" / "latest"), "--work_dir",
             str(d / "jax_eval"), "--max_points", str(MAX_POINTS),
             "--batch_size", "2"])
    return dict(tmp=tmp, paths=paths, jax=jax_results,
                res={k: finish(p) for k, p in procs.items()})


def _ok(runs, key):
    res = runs["res"][key]
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [], got["bad"]
    return got


def jax_evaluation(cfg_path, detections, out_dir):
    """The JAX package's ``NuScenesDataset.evaluation`` of ``detections``
    on the config's val set: the 3-tuple ``tools/dist_test.py`` returns."""
    from partner_tpu.data import build_dataset
    from partner_tpu.train.config import Config

    ds = build_dataset(dict(Config.fromfile(cfg_path).data["val"]))
    return ds.evaluation(detections, output_dir=str(out_dir))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dist_test_matches_jax_cli(runs, name):
    """``dist_test`` from the JAX checkpoint: every frame's kept boxes,
    labels and scores (rows whose scores tie in float32 may come in the
    other order), the nuScenes metrics of the 3-tuple and its results
    json; for the 01voxel config, the metrics and json against the JAX
    dataset's evaluation of the port's detections."""
    got = _ok(runs, (name, "dist_test"))
    cfg, d = runs["paths"][name]
    tp = load_pred(d / "port_eval")
    assert sorted(tp) == [f"nusc{i:04d}" for i in range(4)]
    if name in JAX_CLI:
        jp = load_pred(d / "jax_eval")
        assert sorted(jp) == sorted(tp)
        for token in jp:
            j, t = jp[token], tp[token]
            assert len(t["scores"]) == len(j["scores"]) > 50, token
            assert_same_detections(t, j)
            assert t["metadata"]["n_key_points"] == j["metadata"][
                "n_key_points"]
        jm, seg, pan = runs["jax"][name]
    else:
        assert all(len(t["scores"]) > 50 for t in tp.values())
        jm, seg, pan = jax_evaluation(cfg, tp, d / "jax_eval")
    tm = got["metrics"]
    assert got["rest"] == [seg, pan] == [None, None]
    assert tm.pop("results_path") == str(d / "port_eval" /
                                         "results_nusc.json")
    jm.pop("results_path")
    assert sorted(tm) == sorted(jm)
    assert {"mAP", "NDS", "mATE", "AP/car", "greedy/mAP"} <= set(tm)
    for k in jm:
        if isinstance(jm[k], float) and np.isnan(jm[k]):
            assert tm[k] is None or np.isnan(tm[k]), k
        elif isinstance(jm[k], (int, float)):
            # boxes within 1e-4 m of JAX's; the metrics are sums over them
            assert abs(tm[k] - jm[k]) <= 1e-5, (k, tm[k], jm[k])
        else:
            assert tm[k] == jm[k], k
    with open(d / "port_eval" / "results_nusc.json") as f, open(
            d / "jax_eval" / "results_nusc.json") as g:
        tj, jj = json.load(f), json.load(g)
    assert sorted(tj["results"]) == sorted(jj["results"])
    assert tj["meta"] == jj["meta"]
    for token, boxes in jj["results"].items():
        assert [b["detection_name"] for b in tj["results"][token]] == [
            b["detection_name"] for b in boxes]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_cli_writes_a_checkpoint_that_reloads(runs, name):
    """Two ``train`` CLI steps from the JAX checkpoint at batch 2: finite
    per-task losses each step, one checkpoint at step 2 that loads back
    strictly into a fresh detector, every head's parameters moved."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import load_checkpoint
    from partner_tpu_torch.utils.config import load_config

    assert _ok(runs, (name, "train"))["steps"] == 2
    cfg_path, d = runs["paths"][name]
    work = d / "port_train"
    with open(work / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        for k in ("det_loss", "hm_loss", "loc_loss"):
            assert len(r[k]) == 6 and np.all(np.isfinite(r[k])), (k, r[k])
        assert np.isfinite(r["loss"]) and r["grad_norm"] > 0
    assert "ckpt_00000002" in os.listdir(work)
    cfg = load_config(cfg_path)
    assert cfg["data"]["train"]["nsweeps"] == NUSC_SWEEPS
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="cpu")
    payload, _ = load_checkpoint(str(work / "latest"))
    det.module.load_state_dict(payload["state_dict"], strict=True)
    init, _ = load_checkpoint(str(d / "init" / "latest"))
    moved = [k for k in payload["state_dict"] if k.startswith("bbox_head.")
             and k.endswith("weight") and not torch.equal(
                 payload["state_dict"][k], init["state_dict"][k])]
    assert len(moved) >= 6 * 8, moved
