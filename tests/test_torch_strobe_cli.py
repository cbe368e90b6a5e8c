"""The HAN and STROBE configs through the CLIs on the CPU, against the
JAX package's ``tools/dist_test.py`` and ``tools/train.py``.

A synthetic nuScenes set with lidarseg files (4 frames, 3 sweeps of
~1,500 points, ``write_tiny_nusc_set(..., lidarseg=True)``), each config
cut as ``torch_port_fixtures.write_tiny_strobe_config`` cuts it:

- HAN 1- and 4-sector: ``dist_test`` from one JAX checkpoint of drawn,
  randomized weights in the port (a fresh process, ``--device cpu``, one
  loader thread) and in JAX (this process): every frame's kept boxes
  equal within float32 rounding, the seg mIoU and PQ equal; then two
  port train-CLI steps from that checkpoint: finite losses, HAN 4-sector
  with its 4 sectors' losses.
- The reference side, pinned: HAN 4-sector's pipeline keeps
  ``han_1_sector.py``'s 1-sector ``AssignLabel`` (the file rebinds
  ``assigner`` after building its pipeline), so JAX's train CLI fails at
  its first loss; the port's gives the assigner the model's sector count.
  No loader of either package builds STROBE's (B, S, P, C) batch: JAX's
  ``dist_test`` fails at its init on a (B, P, C) batch, the port's
  ``dist_test`` and ``train`` exit naming the missing sweep-split loader.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest

from test_torch_centerpoint import finish, port, run_jax
from torch_port_fixtures import (STROBE_HAN_CONFIGS, assert_same_detections,
                                 drawn_init, randomize, tiny_strobe_cfg,
                                 write_tiny_nusc_set,
                                 write_tiny_strobe_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAN = ("han-1", "han-4")

_PORT = r"""
import json, os, sys
from partner_tpu_torch.eval import evaluator
from partner_tpu_torch.tools import dist_test, train
work, ckpt = sys.argv[1:3]
orig = evaluator.build_dataloader
# one loader thread: each frame draws its sweeps in frame order
evaluator.build_dataloader = lambda ds, bs, **kw: orig(
    ds, bs, **dict(kw, workers_per_gpu=1))
out = {}
for cfg in sys.argv[3:]:
    name = os.path.splitext(os.path.basename(cfg))[0]
    common = ["--device", "cpu", "--max_points", "5000"]
    (metrics, miou, pan), fps = dist_test.main([
        cfg, "--checkpoint", os.path.join(ckpt, name, "latest"),
        "--work_dir", os.path.join(work, name, "eval")] + common)
    steps = train.main([cfg, "--work_dir", os.path.join(work, name, "train"),
                        "--batch_size", "2", "--total_steps", "2",
                        "--max_steps_per_epoch", "2", "--load_from",
                        os.path.join(ckpt, name, "latest")] + common)
    out[name] = {"miou": miou, "pan": pan, "steps": steps,
                 "nds": metrics["NDS"]}
out["bad"] = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                     "partner_tpu")]
print(json.dumps(out))
"""


def run_jax_dist_test(argv):
    """``tools/dist_test.py`` main() in this process; the tool's random
    init, which the checkpoint replaces, traced for its shapes only."""
    import functools
    from unittest import mock

    import jax
    from partner_tpu.models.detectors import Detector

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import dist_test

    def shapes_only(det, rng, example):
        return jax.eval_shape(functools.partial(det.module.init, train=False),
                              rng, example)

    old = sys.argv
    sys.argv = ["dist_test.py"] + argv
    try:
        with mock.patch.object(Detector, "init", shapes_only):
            return dist_test.main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The set, the HAN config files and a JAX checkpoint each, the port's
    CLIs started in one fresh process, JAX's ``dist_test`` of each in this
    one."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("strobe_cli")
    info = write_tiny_nusc_set(str(tmp), seed=5, lidarseg=True)
    cfgs = {}
    for name in HAN:
        cfgs[name] = write_tiny_strobe_config(str(tmp / f"{name}.py"), info,
                                              info, str(tmp),
                                              STROBE_HAN_CONFIGS[name])
        m, tc = tiny_strobe_cfg(STROBE_HAN_CONFIGS[name])
        rng = np.random.RandomState(7)
        ex = {"points": np.zeros((1, 64, 7), np.float32),
              "points_mask": np.zeros((1, 64), bool)}
        v = randomize(drawn_init(jax_build(m, None, tc).module.init, rng, ex,
                                 train=False), rng)

        class State:   # what save_checkpoint reads of a TrainState
            step, params, batch_stats, opt_state = 0, v["params"], \
                v["batch_stats"], {}

        save_checkpoint(str(tmp / "ckpt" / name), State)
    proc = port(["-c", _PORT, str(tmp / "port"), str(tmp / "ckpt")]
                + list(cfgs.values()))
    jax_res = {name: run_jax_dist_test(
        [cfgs[name], "--checkpoint", str(tmp / "ckpt" / name / "latest"),
         "--work_dir", str(tmp / "jax" / name), "--max_points", "5000"])
        for name in HAN}
    return dict(tmp=tmp, info=info, cfgs=cfgs, jax=jax_res,
                res=finish(proc))


@pytest.mark.parametrize("name", HAN)
def test_han_dist_test_matches_jax_cli(runs, name):
    """``dist_test`` of the same checkpoint: every frame's kept boxes,
    scores and labels equal at their place within float32 rounding (or a
    score tie), the seg mIoU and the panoptic PQ / SQ / RQ equal to JAX's
    (the point labels equal), finite nuScenes metrics; the port's process
    imports nothing of JAX."""
    res = runs["res"]
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    jmetrics, jmiou, jpan = runs["jax"][name]
    assert got[name]["miou"] == jmiou and 0 < jmiou < 1
    assert got[name]["pan"] == jpan
    assert np.isfinite(got[name]["nds"])
    tmp = runs["tmp"]
    with open(tmp / "port" / name / "eval" / "prediction.pkl", "rb") as f:
        tp = pickle.load(f)
    with open(tmp / "jax" / name / "prediction.pkl", "rb") as f:
        jp = pickle.load(f)
    assert sorted(tp) == sorted(jp) and len(jp) == 4
    for tok in jp:
        assert len(jp[tok]["scores"]) > 0
        assert_same_detections(tp[tok], jp[tok], box_tol=1e-4,
                               score_tol=1e-6, tie=1e-6)


@pytest.mark.parametrize("name", HAN)
def test_han_train_cli(runs, name):
    """Two port train-CLI steps at batch 2 from the JAX checkpoint: finite
    losses and gradient norms, every step a record; HAN 4-sector's records
    hold its 4 sectors' losses, its targets assigned on its 4 sectors."""
    res = runs["res"]
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got[name]["steps"] == 2
    with open(runs["tmp"] / "port" / name / "train" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        sectors = sorted(k for k in r if k.startswith("sector"))
        assert sectors == ([f"sector{s}_loss" for s in range(4)]
                           if name == "han-4" else [])
        vals = [r[k] for k in ["loss", "grad_norm", "seg_loss"] + sectors]
        assert np.isfinite(vals).all()


def test_han_4_jax_train_cli_keeps_one_sector_targets(runs, tmp_path):
    """JAX's train CLI on the HAN 4-sector config: its pipeline's
    ``AssignLabel`` assigns one sector's targets (the config file keeps
    ``han_1_sector.py``'s assigner), so the 4-sector loss fails at its
    first step (the sector axis missing from ``hm``): the reference-side
    fault ROADMAP.md §3 records. The port's train CLI ran (above)."""
    from partner_tpu.train.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, STROBE_HAN_CONFIGS["han-4"]))
    stages = [p for p in cfg.train_pipeline if p["type"] == "AssignLabel"]
    assert stages[0]["cfg"].get("nsectors", 1) == 1
    assert cfg.train_cfg["assigner"]["nsectors"] == 4
    with pytest.raises(ValueError, match="out of bounds"):
        run_jax("train", [runs["cfgs"]["han-4"], "--work_dir",
                          str(tmp_path / "jax_train"), "--max_points",
                          "5000", "--batch_size", "2", "--total_steps", "1"])


@pytest.mark.parametrize("name", ["strobe-1", "strobe-4"])
def test_strobe_has_no_loader_in_either_package(runs, tmp_path, name):
    """A STROBE config: JAX's ``dist_test`` fails at its init on the
    loader's (B, P, C) batch (StrobeModule reads axis 1 as sweeps); the
    port's ``dist_test`` and ``train`` exit before they build a dataset,
    naming the (B, S, P, C) contract and the missing sweep-split loader."""
    from partner_tpu_torch.tools import dist_test, train

    cfg = write_tiny_strobe_config(str(tmp_path / f"{name}.py"),
                                   runs["info"], runs["info"],
                                   str(runs["tmp"]),
                                   STROBE_HAN_CONFIGS[name])
    with pytest.raises((IndexError, ValueError)):
        run_jax_dist_test([cfg, "--work_dir", str(tmp_path / "jax"),
                           "--max_points", "5000"])
    for main, tool in ((dist_test.main, "dist_test"), (train.main, "train")):
        with pytest.raises(SystemExit, match="sweep-split loader"):
            main([cfg, "--work_dir", str(tmp_path / tool), "--device",
                  "cpu"])
