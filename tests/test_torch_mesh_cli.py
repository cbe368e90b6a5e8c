"""partner_tpu_torch's CLIs on the mesh's model and azimuth axes, under
torchrun on gloo ranks of the CPU.

``python -m torch.distributed.run --standalone --nproc_per_node N``
starts the train CLI and ``dist_test`` (``--device cpu``) on the tiny
flagship config with one neck scale widened to 128 filters (so that the
model axis slices kernels: ``tests/test_torch_mesh_model.py``), from one
port checkpoint of seeded weights with every norm drawn, at ``--mesh
data=1``, ``model=2`` and ``azimuth=2``, all at once (each rank one
thread). As ``tests/test_train_mesh_cli.py`` holds JAX's meshes against
its data axis:

- ``train --mesh model=2`` logs the ``data=1`` run's losses bit for bit
  (the model ranks compute what one process computes), and its
  checkpoint is the ``data=1`` run's (the slices and their Adam slots
  gathered); ``--mesh azimuth=2`` logs them within ``STEP0_RTOL`` at step
  0 and ``LATER_RTOL`` after (``tests/test_torch_dist_cli.py``'s bounds:
  the chaotic upstream gradients meet Adam's sign-like first update);
- ``dist_test --mesh model=2`` writes the ``data=1`` run's
  ``prediction.pkl`` bit for bit, ``--mesh azimuth=2`` within
  ``tests/torch_port_fixtures.assert_same_detections``'s bounds (the
  sharded neck sums in another order); one copy of each frame;
- every remaining stop exits naming its cause;
- (slow) one ``data=2, model=2, azimuth=2`` train step on eight ranks.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from test_data_pipeline import make_waymo_infos
from test_torch_dist_cli import (LATER_RTOL, MAX_POINTS, STEP0_RTOL, _RUNNER,
                                 finish, metrics, torchrun)
from torch_port_fixtures import (assert_same_detections,
                                 write_tiny_eval_config, write_tiny_pp_config,
                                 write_tiny_train_config)

WIDE = """
model["neck"].update(ds_num_filters=[16, 128], us_num_filters=[32, 128])
bbox_head["in_channels"] = 160
"""
MESHES = ("data=1", "model=2", "azimuth=2")


def _widen(path):
    with open(path, "a") as f:
        f.write(WIDE)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import sys

    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    tmp = tmp_path_factory.mktemp("mesh_cli")
    info = str(make_waymo_infos(tmp, n=4, seed=0))
    cfg = _widen(write_tiny_train_config(str(tmp / "train.py"), info,
                                         str(tmp)))
    eval_cfg = _widen(write_tiny_eval_config(str(tmp / "eval.py"), info,
                                             str(tmp)))
    c = load_config(cfg)
    det = build_detector(c["model"], None, c["test_cfg"], device="cpu",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        chip_smoke.randomize_norms(det.module,
                                   torch.Generator().manual_seed(3))
    weights = save_checkpoint(str(tmp / "weights"), 0,
                              det.module.state_dict())
    runner = str(tmp / "runner.py")
    with open(runner, "w") as f:
        f.write(_RUNNER)
    common = [cfg, "--device", "cpu", "--batch_size", "2", "--total_steps",
              "2", "--max_steps_per_epoch", "2", "--max_points",
              str(MAX_POINTS), "--load_from", weights]
    wd = {}
    procs = {}
    for spec in MESHES:
        n = 1 if spec == "data=1" else 2
        wd["train", spec] = str(tmp / f"train_{spec}")
        wd["eval", spec] = str(tmp / f"eval_{spec}")
        procs["train", spec] = torchrun(runner, n, "train", *common,
                                        "--work_dir", wd["train", spec],
                                        "--mesh", spec)
        procs["eval", spec] = torchrun(
            runner, n, "dist_test", eval_cfg, "--device", "cpu",
            "--checkpoint", weights, "--work_dir", wd["eval", spec],
            "--max_points", str(MAX_POINTS), "--mesh", spec)
    out = {k: finish(p) for k, p in procs.items()}
    return out, wd, cfg, eval_cfg, info, tmp


@pytest.mark.parametrize("spec", ["model=2", "azimuth=2"])
def test_train_mesh_logs_the_data_only_losses(runs, spec):
    """Each logged step of ``train --mesh model=2`` equals the ``data=1``
    run's; ``azimuth=2`` agrees within the data-parallel CLI test's
    bounds. Rank 0 alone logs."""
    out, wd, *_ = runs
    assert [r["out"] for r in out["train", spec]] == [2, 2]
    one, got = metrics(wd["train", "data=1"]), metrics(wd["train", spec])
    assert sorted(one) == sorted(got) == [0, 1]
    for s in one:
        for k in ("loss", "loss_ce", "loss_bbox", "loss_vote",
                  "loss_vote_cls", "grad_norm", "num_matched", "lr"):
            assert np.isfinite(one[s][k])
            if spec == "model=2":
                assert got[s][k] == one[s][k], (s, k)
            else:
                np.testing.assert_allclose(
                    got[s][k], one[s][k], err_msg=(s, k),
                    rtol=STEP0_RTOL if s == 0 else LATER_RTOL)
    assert len([f for f in os.listdir(wd["train", spec])
                if f.endswith(".log")]) == 1


def test_model2_checkpoint_is_the_data_only_runs(runs):
    """The ``model=2`` run's checkpoint holds whole tensors, the ``data=1``
    run's bit for bit: weights, statistics, the Adam count and moments."""
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    _, wd, *_ = runs
    a = load_checkpoint(os.path.join(wd["train", "data=1"], "latest"))[0]
    b = load_checkpoint(os.path.join(wd["train", "model=2"], "latest"))[0]
    assert a["step"] == b["step"] == 2
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    for k, t in a["state_dict"].items():
        assert torch.equal(b["state_dict"][k], t), k
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 2
    for slot in ("mu", "nu"):
        for k, t in a["opt_state"][slot].items():
            assert torch.equal(b["opt_state"][slot][k], t), (slot, k)


def _predictions(path):
    with open(os.path.join(path, "prediction.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("spec", ["model=2", "azimuth=2"])
def test_dist_test_mesh_writes_the_data_only_predictions(runs, spec):
    """``dist_test`` on the mesh: rank 0 evaluates, the other returns
    None; ``prediction.pkl`` holds each frame once, in the dataset's
    order, equal to the ``data=1`` run's (``model=2`` bit for bit)."""
    out, wd, *_ = runs
    assert out["eval", spec][0]["out"]["result"] is not None
    assert out["eval", spec][1]["out"]["result"] is None
    want = _predictions(wd["eval", "data=1"])
    got = _predictions(wd["eval", spec])
    assert list(got) == list(want) and len(want) == 4
    for token, frame in want.items():
        if spec == "model=2":
            for k, v in frame.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[token][k], v)
        else:
            assert_same_detections(got[token], frame)


@pytest.mark.parametrize("tool", ["train", "dist_test"])
def test_remaining_stops_name_their_cause(runs, tool):
    """A mesh that is not the world's (data=2 in one process), the azimuth
    axis on a PointPillars config, and azimuth rows that do not split
    (the tiny grid's 32 over 3) stop either CLI before it builds anything,
    naming the cause."""
    from partner_tpu_torch.tools import dist_test, train

    _, _, cfg, eval_cfg, info, tmp = runs
    pp = write_tiny_pp_config(str(tmp / "pp.py"), info, info, str(tmp))
    main = train.main if tool == "train" else dist_test.main
    base = cfg if tool == "train" else eval_cfg
    for config, spec, says in (
            (base, "data=2", "2 processes, but 1 run"),
            (pp, "azimuth=2", "detector PointPillars takes no bev_pspec"),
            (base, "azimuth=3", "32 azimuth rows do not split into 3")):
        work = str(tmp / f"stop_{tool}_{spec}")
        with pytest.raises(SystemExit, match=says):
            main([config, "--device", "cpu", "--work_dir", work, "--mesh",
                  spec])
        assert not os.path.exists(work)


@pytest.mark.slow
def test_data2_model2_azimuth2_cli_step(runs):
    """One ``train --mesh data=2,model=2,azimuth=2`` step on eight ranks
    (a global batch of 2, one sample a data coordinate) logs the
    ``data=1`` run's step-0 losses within ``STEP0_RTOL``."""
    out, wd, cfg, _, _, tmp = runs
    runner = str(tmp / "runner.py")
    work = str(tmp / "train_8")
    weights = os.path.join(str(tmp), "weights", "latest")
    res = finish(torchrun(runner, 8, "train", cfg, "--device", "cpu",
                          "--batch_size", "2", "--total_steps", "1",
                          "--max_points", str(MAX_POINTS), "--load_from",
                          weights, "--work_dir", work, "--mesh",
                          "data=2,model=2,azimuth=2"))
    assert [r["out"] for r in res] == [1] * 8
    one, got = metrics(wd["train", "data=1"]), metrics(work)
    for k in ("loss", "loss_ce", "loss_bbox", "grad_norm"):
        np.testing.assert_allclose(got[0][k], one[0][k], rtol=STEP0_RTOL,
                                   err_msg=k)
