"""The port's train CLI against the JAX package's, on a tiny config.

``tests/torch_port_fixtures.write_tiny_train_config`` cuts the flagship
config to the tiny grid and widths with every drop rate 0, no augmentation
and no GT-AUG, so neither package draws at random. One JAX checkpoint of
randomized weights starts both sides. ``tools/train.py`` (JAX, ``--mesh
data=1``) runs in this process; ``python -m partner_tpu_torch.tools.train
--device cpu`` runs in fresh processes, which must import nothing of jax,
flax, optax or ``partner_tpu``.

Tolerances, measured on the CPU with this fixture (seed 7). Step 0 starts
from the same weights on both sides: its loss terms agree to ~1e-6 and the
gradient norm to 4e-4. At random weights the train-mode network upstream
of the head is chaotic (the gradients of two float32 implementations
differ ~1.2% there), and Adam's first update is close to ``lr * sign(g)``,
so the small gradients whose sign flips move the weights apart: the
update after step 0 differs 9-13% by module, the total loss 0.13% at step
1 and 2.5% at step 2 (loss terms up to 0.33% and 8.7%). The bounds below
are 3-10x those. Resuming the port from JAX's checkpoint after 2 steps
takes the same step 2: its loss terms agree to ~1e-6, and the update it
makes agrees with JAX's to 0.8% (Adam moments to 2e-5), against 88% (and
moments 85%) when the same weights resume with zeroed Adam state.
"""

import ast
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_data_pipeline import make_waymo_infos
from torch_port_fixtures import (randomize, tiny_frame_cfg,
                                 write_tiny_pp_config,
                                 write_tiny_train_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_POINTS = 5000
# per step of --load_from runs: (bound on |port - jax| / |jax| of the total
# loss, of each loss term, of the gradient norm)
LOAD_FROM_TOL = [(1e-4, 1e-4, 2e-3), (0.01, 0.05, 0.05), (0.1, 0.25, 0.25)]
LOAD_FROM_STATS_TOL = 1e-5  # BatchNorm statistics after step 0
RESUME_LOSS_TOL = 1e-4      # step 2 resumed from JAX's checkpoint
RESUME_UPDATE_TOL = 0.05    # relative RMS of the update against JAX's
RESUME_MOMENT_TOL = 1e-3    # relative RMS of the Adam moments
ZEROED_UPDATE_MIN = 0.3     # the update with zeroed Adam state is this far

_PORT_CLI = r"""
import json, sys
from partner_tpu_torch.tools import train
steps = train.main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "steps": steps}))
"""

_PORT_DIST_TEST = r"""
import json, sys
from partner_tpu_torch.tools import dist_test
(metrics, _), _ = dist_test.main(sys.argv[1:])
print(json.dumps(metrics))
"""


def port(args):
    """A port entry point in a fresh process (started, not awaited)."""
    return subprocess.Popen(
        [sys.executable] + args, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc):
    out, err = proc.communicate(timeout=600)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def train_args(cfg, work_dir, total, per_epoch, *extra):
    return ["-c", _PORT_CLI, cfg, "--device", "cpu", "--work_dir",
            str(work_dir), "--batch_size", "2", "--total_steps", str(total),
            "--max_steps_per_epoch", str(per_epoch), "--max_points",
            str(MAX_POINTS)] + list(extra)


def run_jax_cli(argv):
    """``tools/train.py`` in this process -> num_matched of each step
    (read on the device through a callback: the JAX CLI logs only the loss
    terms and the gradient norm)."""
    import jax

    import partner_tpu.train.train_state as jts

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train as jax_train

    seen, orig, old_argv = [], jts.make_train_step, sys.argv

    def recording(det, tx):
        base = orig(det, tx)

        def step(state, ex, rng):
            state, met = base(state, ex, rng)
            jax.debug.callback(lambda n: seen.append(float(n)),
                               met["num_matched"])
            return state, met

        return step

    jts.make_train_step, sys.argv = recording, ["train.py"] + argv
    try:
        jax_train.main()
    finally:
        jts.make_train_step, sys.argv = orig, old_argv
    return seen


def read_metrics(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def ckpt(work_dir, step):
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(os.path.join(work_dir, f"ckpt_{step:08d}"))[0]


def rel_rms(pairs):
    num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    den = sum(float((b ** 2).sum()) for _, b in pairs)
    return (num / den) ** 0.5


def is_param(name):
    return not name.endswith(("running_mean", "running_var", "_mean", "_var"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint as jax_save
    from partner_tpu_torch.train.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("train_cli")
    info_path = make_waymo_infos(tmp, n=4, seed=7)
    cfg = write_tiny_train_config(str(tmp / "cfg.py"), info_path, str(tmp))
    model_cfg, test_cfg = tiny_frame_cfg()
    z = np.zeros((1, 64, 7), np.float32)
    v = randomize(jax_build(model_cfg, None, test_cfg).init(
        jax.random.PRNGKey(0), {"points": z,
                                "points_mask": np.zeros((1, 64), bool)}),
        np.random.RandomState(7))

    class State:   # what save_checkpoint reads of a TrainState
        step, params, batch_stats, opt_state = 0, v["params"], \
            v["batch_stats"], {}

    jax_save(str(tmp / "init"), State)
    init = ["--load_from", str(tmp / "init" / "latest")]

    procs = {
        "a": port(train_args(cfg, tmp / "port_a", 3, 1, *init)),
        # every val frame: with a frame cap, the loader's threads decide
        # which frames come first
        "b1": port(train_args(cfg, tmp / "port_b1", 4, 2, "--validate",
                              *init)),
        "e": port(["-m", "partner_tpu_torch.tools.train", cfg, "--work_dir",
                   str(tmp / "nocard")]),
    }
    jax_matched = run_jax_cli(
        [cfg, "--work_dir", str(tmp / "jax"), "--batch_size", "2",
         "--total_steps", "3", "--max_steps_per_epoch", "1", "--max_points",
         str(MAX_POINTS), "--mesh", "data=1"] + init)

    # the weights of JAX's step 2 with zeroed Adam state: the control of (c)
    jax2 = ckpt(tmp / "jax", 2)
    zeroed = {m: {k: torch.zeros_like(t)
                  for k, t in jax2["opt_state"][m].items()}
              for m in ("mu", "nu")}
    save_checkpoint(str(tmp / "zeroed"), 2, jax2["state_dict"],
                    opt_state=dict(zeroed, count=0))
    procs["c"] = port(train_args(cfg, tmp / "port_c", 3, 1, "--resume_from",
                                 str(tmp / "jax" / "ckpt_00000002")))
    procs["z"] = port(train_args(cfg, tmp / "port_z", 3, 1, "--resume_from",
                                 str(tmp / "zeroed" / "latest")))
    res = {"b1": finish(procs.pop("b1"))}
    assert res["b1"].returncode == 0, res["b1"].stderr
    # (b): b1's step-2 checkpoint as a stopped run leaves it, resumed
    # through work_dir/latest
    os.makedirs(tmp / "port_b2")
    shutil.copytree(tmp / "port_b1" / "ckpt_00000002",
                    tmp / "port_b2" / "ckpt_00000002")
    (tmp / "port_b2" / "latest").write_text("ckpt_00000002")
    procs["b2"] = port(train_args(cfg, tmp / "port_b2", 4, 2))
    procs["d"] = port(["-c", _PORT_DIST_TEST, cfg, "--checkpoint",
                       str(tmp / "port_b1" / "latest"), "--device", "cpu",
                       "--work_dir", str(tmp / "dist_test"), "--max_points",
                       str(MAX_POINTS)])
    res.update({k: finish(p) for k, p in procs.items()})
    return dict(tmp=tmp, jax_matched=jax_matched, res=res)


def ok(runs, name):
    res = runs["res"][name]
    assert res.returncode == 0, res.stderr[-3000:]
    return res


@pytest.mark.parametrize("name", ["a", "b1", "b2", "c"])
def test_port_cli_imports_nothing_of_jax(runs, name):
    got = json.loads(ok(runs, name).stdout.strip().splitlines()[-1])
    assert got["bad"] == [], got["bad"]
    assert got["steps"] == (4 if name.startswith("b") else 3)


def test_load_from_steps_match_jax(runs):
    """(a) Both CLIs --load_from one JAX checkpoint, 3 steps."""
    ok(runs, "a")
    jm, pm = read_metrics(runs["tmp"] / "jax"), read_metrics(
        runs["tmp"] / "port_a")
    assert [r["step"] for r in pm] == [r["step"] for r in jm] == [0, 1, 2]
    assert [r["num_matched"] for r in pm] == runs["jax_matched"]
    for j, p, (loss_tol, term_tol, norm_tol) in zip(jm, pm, LOAD_FROM_TOL):
        assert p["lr"] == pytest.approx(j["lr"], rel=1e-6)
        terms = [k for k in j if k.startswith("loss")]
        assert sorted(terms) == sorted(k for k in p if k.startswith("loss"))
        for k in terms:
            tol = loss_tol if k == "loss" else term_tol
            assert abs(p[k] - j[k]) <= tol * abs(j[k]), (j["step"], k, p[k],
                                                        j[k])
        assert abs(p["grad_norm"] - j["grad_norm"]) <= norm_tol * j[
            "grad_norm"], (j["step"], p["grad_norm"], j["grad_norm"])
    # --load_from leaves the BatchNorm statistics at their initial values
    # on both sides (the checkpoint's are randomized): after step 0, from
    # the same weights, they agree (5.9e-7 measured)
    jax1, port1 = ckpt(runs["tmp"] / "jax", 1), ckpt(runs["tmp"] / "port_a", 1)
    stats = [k for k in port1["state_dict"] if not is_param(k)]
    assert len(stats) > 10
    assert rel_rms([(port1["state_dict"][k], jax1["state_dict"][k])
                    for k in stats]) <= LOAD_FROM_STATS_TOL


def test_resume_is_bit_exact(runs):
    """(b) 4 steps straight against 2 steps and a resume of 2 through
    work_dir/latest (the straight run also validated after each epoch)."""
    ok(runs, "b2")
    assert "resumed from" in runs["res"]["b2"].stderr
    a, b = ckpt(runs["tmp"] / "port_b1", 4), ckpt(runs["tmp"] / "port_b2", 4)
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    for k, t in a["state_dict"].items():
        assert torch.equal(t, b["state_dict"][k]), k
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4
    for m in ("mu", "nu"):
        for k, t in a["opt_state"][m].items():
            assert torch.equal(t, b["opt_state"][m][k]), (m, k)
    def steps(work_dir):   # the records less their phase times
        return [{k: v for k, v in r.items() if not k.endswith("time")}
                for r in read_metrics(work_dir)]

    assert steps(runs["tmp"] / "port_b1")[2:] == steps(
        runs["tmp"] / "port_b2")


def test_resume_from_jax_carries_the_adam_state(runs):
    """(c) The port resumed from JAX's checkpoint after 2 steps: step 2
    equal to JAX's step 2, and the update it makes equal to JAX's, far
    closer than the same weights with zeroed Adam state."""
    ok(runs, "c")
    ok(runs, "z")
    tmp = runs["tmp"]
    j = read_metrics(tmp / "jax")[2]
    p = read_metrics(tmp / "port_c")
    assert [r["step"] for r in p] == [2]
    for k in j:
        if k.startswith("loss"):
            assert abs(p[0][k] - j[k]) <= RESUME_LOSS_TOL * abs(j[k]), k
    assert p[0]["num_matched"] == runs["jax_matched"][2]
    before, want = ckpt(tmp / "jax", 2), ckpt(tmp / "jax", 3)
    errs = {}
    for tag in ("port_c", "port_z"):
        got = ckpt(tmp / tag, 3)
        names = [k for k in got["state_dict"] if is_param(k)]
        errs[tag] = rel_rms(
            [(got["state_dict"][k] - before["state_dict"][k],
              want["state_dict"][k] - before["state_dict"][k])
             for k in names])
        errs[tag + " moments"] = max(rel_rms(
            [(got["opt_state"][m][k], want["opt_state"][m][k])
             for k in names]) for m in ("mu", "nu"))
    assert ckpt(tmp / "port_c", 3)["opt_state"]["count"] == 3
    assert errs["port_c"] <= RESUME_UPDATE_TOL, errs
    assert errs["port_c moments"] <= RESUME_MOMENT_TOL, errs
    assert errs["port_z"] >= ZEROED_UPDATE_MIN, errs


def test_validate_matches_dist_test(runs):
    """(d) --validate logs [val] each epoch and writes prediction.pkl;
    dist_test from the run's latest checkpoint gives the same predictions
    and metrics."""
    err = runs["res"]["b1"].stderr
    vals = [line.split("[val] epoch ", 1)[1] for line in err.splitlines()
            if "[val] epoch " in line]
    assert [v.split(":", 1)[0] for v in vals] == ["1", "2"]
    val_metrics = ast.literal_eval(vals[-1].split(": ", 1)[1])
    got = json.loads(ok(runs, "d").stdout.strip().splitlines()[-1])
    assert got == val_metrics and "mAPH/L2" in got

    def pred(d):
        with open(runs["tmp"] / d / "prediction.pkl", "rb") as f:
            return pickle.load(f)

    a, b = pred("port_b1"), pred("dist_test")
    assert sorted(a) == sorted(b) and len(a) == 4
    for token in a:
        assert len(a[token]["scores"]) > 0
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(a[token][k], b[token][k])


def test_no_card_without_device_cpu_fails(runs):
    """(e) The default device is the card: without one the CLI stops."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    res = runs["res"]["e"]
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not os.path.exists(runs["tmp"] / "nocard" / "latest")


def test_hooks_match_jax():
    """LogBuffer means, the text logger's line and the metrics sink's
    records equal the JAX package's for the same updates."""
    import logging

    from partner_tpu.train import hooks as jh
    from partner_tpu_torch.train import hooks as th

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    out = {}
    for tag, h in (("jax", jh), ("port", th)):
        logger = logging.getLogger(f"hooks_test_{tag}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        lines = Lines()
        logger.addHandler(lines)
        buf, recs = h.LogBuffer(), []
        text = h.TextLoggerHook(logger, interval=3)
        sink = h.PaviLoggerHook(sink=recs.append, interval=2)
        vals = np.random.RandomState(3).rand(7, 3)
        for step, (a, b, c) in enumerate(vals):
            buf.update({"loss": a, "loss_ce": b, "data_time": c})
            sink.log(step, {"loss": a, "num": np.float32(b), "bad": "x"},
                     lr=c, epoch=step // 4)
            text.after_iter(buf, step, step // 4, 1e-3 * a, 4)
        out[tag] = (lines.lines, recs)
    assert out["port"] == out["jax"]
    assert len(out["jax"][0]) == 2 and len(out["jax"][1]) == 4


@pytest.mark.parametrize("case", ["mesh", "lr_config", "curriculum"])
def test_what_is_not_ported_exits(tmp_path, case):
    """A --mesh the processes running cannot run (a data axis of 2 in one
    process; the azimuth axis on a PointPillars config, whose JAX builder
    takes no ``bev_pspec``) stops the run before anything is built,
    naming its cause. A non-one-cycle lr_config and curriculum_weights,
    once such stops, are ported (the lr family; the seg heads): a det-only
    config trains with each (the curriculum weight scales a seg loss it
    has none of, as in JAX; ``tests/test_torch_seg.py`` holds it on the
    seg configs, ``tests/test_torch_optim_family.py`` the family)."""
    from partner_tpu_torch.tools import train

    info_path = make_waymo_infos(tmp_path, n=2, seed=1)
    cfg = write_tiny_train_config(str(tmp_path / "cfg.py"), info_path,
                                  str(tmp_path))
    argv = [cfg, "--device", "cpu", "--work_dir", str(tmp_path / "wd")]
    if case == "mesh":
        pp = write_tiny_pp_config(str(tmp_path / "pp.py"), info_path,
                                  info_path, str(tmp_path))
        for config, mesh, says in (
                (cfg, "data=2", "asks for data=2"),
                (pp, "azimuth=2", "detector PointPillars takes no "
                                  "bev_pspec")):
            with pytest.raises(SystemExit, match=says):
                train.main([config] + argv[1:] + ["--mesh", mesh])
        assert not os.path.exists(tmp_path / "wd")
        return
    with open(cfg, "a") as f:
        f.write('lr_config = dict(type="cosine", lr=1e-3)\n'
                if case == "lr_config" else "curriculum_weights = [0.5, 1.0]\n")
    assert train.main(argv + ["--batch_size", "2", "--total_steps",
                              "1"]) == 1
    assert os.path.exists(tmp_path / "wd" / "latest")

