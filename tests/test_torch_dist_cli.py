"""partner_tpu_torch's CLIs under torchrun on two gloo ranks of the CPU.

``python -m torch.distributed.run --standalone --nproc_per_node N`` starts
the port's train CLI and ``dist_test`` at N = 1 and N = 2 (``--mesh
data=N --device cpu``) on the tiny flagship config
(``tests/torch_port_fixtures.write_tiny_train_config``: no random draw
in the data path, drop rates 0), from one port checkpoint of seeded
weights with every norm drawn, and with the lr family's optimizer
(``adamw`` under a cosine schedule after a linear warmup). As
``tests/test_train_mesh_cli.py`` holds JAX's ``data=2`` mesh against
``data=1``:

- the two-rank train run logs the one-rank run's losses at every step
  (step 0 from the same weights within float32 rounding, ``STEP0_RTOL``;
  the next steps within ``LATER_RTOL``: at random weights the network
  upstream of the head is chaotic and Adam's first update sign-like, so
  rounding in the first step's gradients moves the next losses, as
  ``tests/test_torch_train_cli.py`` measures between the two packages),
  and the schedule's lr;
- a run resumed at step 2 from either run's checkpoint, on the other
  number of ranks, takes that run's step 2 (its weights and Adam state
  restored: the same loss within ``STEP0_RTOL``), and the checkpoints hold
  the module's own names (no ``module.`` prefix);
- ``dist_test`` at two ranks (a global batch of 2, one frame a rank)
  writes a ``prediction.pkl`` bit-equal to the one-rank run's (the same
  frames in the same order, every array bit-equal), and only rank 0
  evaluates.
"""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_data_pipeline import make_waymo_infos
from torch_port_fixtures import (tiny_frame_cfg, write_tiny_eval_config,
                                 write_tiny_train_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_POINTS = 5000
STEP0_RTOL = 1e-4
LATER_RTOL = 2e-2

_RUNNER = r"""
import json, sys
import torch.distributed as tdist
from partner_tpu_torch.tools import dist_test, train
tool = sys.argv[1]
if tool == "train":
    out = train.main(sys.argv[2:])
else:
    result, fps = dist_test.main(sys.argv[2:])
    out = {"result": None if result is None else repr(result)[:200],
           "fps": fps}
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
import os
print("RESULT " + json.dumps({"rank": int(os.environ["RANK"]),
                               "out": out, "bad": bad,
                               "group_left": not tdist.is_initialized()}),
      flush=True)
"""


def torchrun(runner, n, tool, *argv):
    """The port's ``tool`` main on ``n`` ranks under torchrun (started,
    not awaited)."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), runner, tool, *argv], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    # torchrun relays the ranks' output, and two ranks' lines may run
    # together: each record is read from its "RESULT " on
    dec = json.JSONDecoder()
    res = [dec.raw_decode(out, m.end())[0]
           for m in re.finditer("RESULT ", out)]
    assert res and sorted(r["rank"] for r in res) == list(range(len(res)))
    assert not any(r["bad"] for r in res)
    assert all(r["group_left"] for r in res)
    return sorted(res, key=lambda r: r["rank"])


def metrics(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import save_checkpoint

    sys.path.insert(0, ROOT)
    import chip_smoke

    tmp = tmp_path_factory.mktemp("dist_cli")
    info = make_waymo_infos(tmp, n=4, seed=0)
    cfg = write_tiny_train_config(str(tmp / "train.py"), str(info), str(tmp))
    with open(cfg, "a") as f:
        f.write('\nlr_config = dict(type="cosine", lr=1e-3, target_lr=1e-5, '
                'warmup="linear", warmup_iters=1, warmup_ratio=0.1, '
                'by_epoch=False)\noptimizer = dict(type="adamw", '
                'betas=(0.9, 0.99), wd=0.01)\n')
    eval_cfg = write_tiny_eval_config(str(tmp / "eval.py"), str(info),
                                      str(tmp))
    m, tc = tiny_frame_cfg()
    det = build_detector(m, None, tc, device="cpu",
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
              "3", "--max_steps_per_epoch", "2", "--max_points",
              str(MAX_POINTS)]
    wd = {k: str(tmp / k) for k in ("one", "two", "two_from_one",
                                    "one_from_two", "eval1", "eval2")}
    first = [torchrun(runner, 1, "train", *common, "--work_dir", wd["one"],
                      "--load_from", weights, "--mesh", "data=1"),
             torchrun(runner, 2, "train", *common, "--work_dir", wd["two"],
                      "--load_from", weights, "--mesh", "data=2"),
             torchrun(runner, 1, "dist_test", eval_cfg, "--device", "cpu",
                      "--checkpoint", weights, "--work_dir", wd["eval1"],
                      "--max_points", str(MAX_POINTS)),
             torchrun(runner, 2, "dist_test", eval_cfg, "--device", "cpu",
                      "--checkpoint", weights, "--work_dir", wd["eval2"],
                      "--max_points", str(MAX_POINTS), "--batch_size", "2",
                      "--mesh", "data=2")]
    out = dict(zip(("one", "two", "eval1", "eval2"), map(finish, first)))
    ck2 = lambda k: os.path.join(wd[k], "ckpt_00000002")
    second = [torchrun(runner, 2, "train", *common, "--work_dir",
                       wd["two_from_one"], "--resume_from", ck2("one")),
              torchrun(runner, 1, "train", *common, "--work_dir",
                       wd["one_from_two"], "--resume_from", ck2("two"))]
    out.update(zip(("two_from_one", "one_from_two"), map(finish, second)))
    return out, wd, weights


def test_two_ranks_log_the_one_rank_losses(runs):
    """Every logged step of the two-rank run against the one-rank run,
    rank 0 alone logging, and the lr the schedule's."""
    from partner_tpu_torch.train.optim import build_lr_schedule

    out, wd, _ = runs
    assert [r["out"] for r in out["one"]] == [3]
    assert [r["out"] for r in out["two"]] == [3, 3]
    one, two = metrics(wd["one"]), metrics(wd["two"])
    assert sorted(one) == sorted(two) == [0, 1, 2]
    sched = build_lr_schedule(dict(type="cosine", lr=1e-3, target_lr=1e-5,
                                   warmup="linear", warmup_iters=1,
                                   warmup_ratio=0.1, by_epoch=False), 3)
    for s in one:
        rtol = STEP0_RTOL if s == 0 else LATER_RTOL
        for k in ("loss", "loss_ce", "loss_bbox", "loss_vote",
                  "loss_vote_cls", "grad_norm"):
            assert np.isfinite(one[s][k])
            np.testing.assert_allclose(two[s][k], one[s][k], rtol=rtol,
                                       err_msg=(s, k))
        assert two[s]["num_matched"] == one[s]["num_matched"]
        assert one[s]["lr"] == two[s]["lr"] == float(sched(s))
    assert one[0]["lr"] != one[1]["lr"]
    logs = [f for f in os.listdir(wd["two"]) if f.endswith(".log")]
    assert len(logs) == 1


def test_resume_from_either_runs_checkpoint(runs):
    """Step 2 resumed on two ranks from the one-rank run's checkpoint, and
    on one rank from the two-rank run's, takes the unbroken run's step 2;
    every checkpoint holds the module's names and the AdamW state."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    out, wd, _ = runs
    for resumed, source in (("two_from_one", "one"), ("one_from_two",
                                                      "two")):
        got, want = metrics(wd[resumed]), metrics(wd[source])
        assert sorted(got) == [2]
        for k in ("loss", "loss_ce", "loss_bbox", "grad_norm"):
            np.testing.assert_allclose(got[2][k], want[2][k],
                                       rtol=STEP0_RTOL, err_msg=(resumed, k))
    m, tc = tiny_frame_cfg()
    names = sorted(build_detector(m, None, tc, device="meta")
                   .module.state_dict())
    for k in ("one", "two", "two_from_one", "one_from_two"):
        payload, _ = load_checkpoint(os.path.join(wd[k], "latest"))
        assert payload["step"] == 3
        assert sorted(payload["state_dict"]) == names
        assert sorted(payload["opt_state"]) == ["count", "mu", "nu"]
        assert payload["opt_state"]["count"] == 3


def test_dist_test_two_ranks_write_the_one_rank_predictions(runs):
    """Two ranks, a global batch of 2: ``prediction.pkl`` bit-equal to one
    rank's at batch 1 (each frame predicted alone on either side), and the
    metrics on rank 0 alone."""
    out, wd, _ = runs
    one, two = out["eval1"], out["eval2"]
    assert one[0]["out"]["result"] is not None
    assert two[0]["out"]["result"] == one[0]["out"]["result"]
    assert two[1]["out"]["result"] is None
    with open(os.path.join(wd["eval1"], "prediction.pkl"), "rb") as f:
        a = pickle.load(f)
    with open(os.path.join(wd["eval2"], "prediction.pkl"), "rb") as f:
        b = pickle.load(f)
    assert list(a) == list(b) and len(a) == 4   # frames in dataset order
    for token, frame in a.items():
        assert sorted(frame) == sorted(b[token])
        for k, v in frame.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b[token][k].dtype
                np.testing.assert_array_equal(b[token][k], v,
                                              err_msg=(token, k))
            else:
                assert b[token][k] == v
