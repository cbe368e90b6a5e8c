"""The CenterPoint family in partner_tpu_torch against the JAX package (CPU).

The Waymo CenterPoint configs (``VoxelNet`` on the ``PolarDenseFHD`` point
path with its 3D trunk, ``RPN``, ``CenterHead``) cut to the tiny grid and
a narrow RPN, float32: the frame (head maps, decoded boxes, kept NMS
indices) for the one-sweep and the two-sweep velocity config, the stem at
the two-sweep width C_in 11, one train step against
``jax.jit(make_train_step)``, and both entry points from one JAX
checkpoint: ``dist_test --device cpu`` against ``tools/dist_test.py`` and
two train-CLI steps against ``tools/train.py --mesh data=1``. The port's
CLIs run in fresh processes, which must import nothing of jax, flax,
optax or ``partner_tpu``.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CENTERPOINT, CENTERPOINT_VELO,
                                 load_converted, randomize, synthetic_points,
                                 tiny_centerpoint_cfg, write_three_class_infos,
                                 write_tiny_centerpoint_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"one-sweep": CENTERPOINT, "two-sweep-velo": CENTERPOINT_VELO}
ZOO = ["configs/waymo/waymo_centerpoint_voxelnet_36epoch.py",
       "configs/waymo/waymo_centerpoint_voxelnet_1x.py",
       "configs/waymo/waymo_centerpoint_voxelnet_3epoch.py",
       "configs/waymo/waymo_centerpoint_voxelnet_6epoch.py",
       "configs/waymo/waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py"]
MAX_POINTS = 5000


def _jax_init(jdet, c, rng):
    z = np.zeros((1, 64, c), np.float32)
    return randomize(jdet.init(jax.random.PRNGKey(0), {
        "points": z, "points_mask": np.zeros((1, 64), bool)}), rng)


@pytest.fixture(scope="module", params=list(CONFIGS))
def frames(request):
    """Both packages' frame of one config on the same sweep: (JAX maps,
    JAX detections, port maps, port detections) as numpy."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    rng = np.random.RandomState(0)
    m, tc = tiny_centerpoint_cfg(CONFIGS[request.param])
    c = m["backbone"]["num_input_features"]
    pts, mask = synthetic_points(rng, m["bbox_head"]["voxel_generator"][
        "range"], 2000, 2400, c=c)
    jdet = jax_build(m, None, tc)
    v = _jax_init(jdet, c, rng)
    ex = {"points": pts, "points_mask": mask}
    jmaps = jax.jit(lambda v, e: jdet.module.apply(v, e, train=False))(v, ex)
    jout = jax.jit(jdet.predict)(v, ex)
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    tex = {k: torch.from_numpy(a) for k, a in ex.items()}
    with torch.no_grad():
        tmaps = tdet.module(tex)
    tout = tdet.predict(tex)
    as_np = lambda d: {k: np.asarray(x) for k, x in d.items()}
    return (request.param, [as_np(t) for t in jmaps["det_preds"]],
            as_np(jout), [as_np(t) for t in tmaps["det_preds"]], as_np(tout))


def test_frame_head_maps_match_jax(frames):
    name, jmaps, _, tmaps, _ = frames
    assert len(tmaps) == len(jmaps) == 1
    heads = ["dim", "height", "hm", "reg", "rot"] + (
        ["vel"] if name == "two-sweep-velo" else [])
    assert list(tmaps[0]) == list(jmaps[0]) == heads
    for k in heads:
        # stem, 3D trunk, RPN and head in f32, another summation order:
        # ~2e-6 measured against maps of magnitude ~1
        np.testing.assert_allclose(tmaps[0][k], jmaps[0][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_frame_detections_match_jax(frames):
    name, _, jout, _, tout = frames
    assert tout["mask"].shape == jout["mask"].shape == (1, 64)
    assert tout["box3d_lidar"].shape[-1] == (9 if "velo" in name else 7)
    assert tout["mask"].sum() > 10  # score_threshold 0: NMS did real work
    # the kept set, its order and labels are exact
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    m = jout["mask"]
    # decode of the maps above (exp / atan2 in f32); boxes reach ~75 m
    np.testing.assert_allclose(tout["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                               rtol=1e-5, atol=1e-6)


def _stem_inputs(rng, cin, b=2, p=300):
    x = rng.randn(b, cin, p).astype(np.float32)
    mask = rng.rand(b, p) > 0.2
    w1 = (rng.randn(32, cin) * 0.3).astype(np.float32)
    w2 = (rng.randn(64, 32) * 0.2).astype(np.float32)
    a1, a2 = (rng.uniform(0.5, 1.5, f).astype(np.float32) for f in (32, 64))
    b1, b2 = (rng.normal(0, 0.2, f).astype(np.float32) for f in (32, 64))
    return x, mask, w1, a1, b1, w2, a2, b2


@pytest.mark.parametrize("p", [17, 300])
def test_plain_stem_at_cin11_matches_jax(rng, p):
    """The two-sweep configs' stem width (8 features + 3 decorations): the
    port's plain twin against the Pallas kernel in interpret mode and
    against the JAX package's own plain stem (``PolarDenseFHD._stem_t``,
    the XLA stages) with the same folded BatchNorm."""
    from partner_tpu.models.backbone_dense import PolarDenseFHD as JaxFHD
    from partner_tpu.ops import stem_pallas
    from partner_tpu_torch.ops import stem

    args = _stem_inputs(rng, 11, p=p)
    x, mask, *w = args
    out = stem.stem2_channel_major_plain(
        *(torch.from_numpy(a) for a in args)).numpy()
    pallas = np.stack([np.asarray(stem_pallas.stem2_channel_major(
        jnp.asarray(x[i]), jnp.asarray(mask[i]),
        *(jnp.asarray(a) for a in w), interpret=True, chunk=128))
        for i in range(x.shape[0])])
    assert out.shape == pallas.shape == (2, 64, p)
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)

    # the JAX plain stem: unit variance, zero mean, so its BatchNorm folds
    # to a = scale * rsqrt(1 + 1e-3), b = shift
    w1, a1, b1, w2, a2, b2 = w
    eps = np.float32(1e-3)
    scale = lambda a: (a * np.sqrt(1 + eps)).astype(np.float32)
    params = {"stem0_kernel": w1.T, "stem0_scale": scale(a1),
              "stem0_bias": b1, "stem1_kernel": w2.T,
              "stem1_scale": scale(a2), "stem1_bias": b2}
    stats = {f"stem{i}_{s}": (np.zeros if s == "mean" else np.ones)(
        f, np.float32) for i, f in enumerate((32, 64))
        for s in ("mean", "var")}
    fhd = JaxFHD(num_input_features=8, compute_dtype=jnp.float32,
                 trunk2d=True, a2d_features=8, out_features=8)
    ref = fhd.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), jnp.asarray(mask), False,
                    method=lambda mod, *a: mod._stem_t(*a))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)


def _step_example(rng, m, tc):
    import chip_smoke

    from partner_tpu_torch.utils.config import load_config

    train_cfg = load_config(os.path.join(ROOT, CENTERPOINT))["train_cfg"]
    return chip_smoke.centerpoint_train_example(
        rng, m, train_cfg, 2, 1500, 1800, 12)


def test_whole_train_step_matches_jax(rng):
    """One step of the tiny one-sweep config, f32, b = 2, with the port's
    center targets, against ``jax.jit(make_train_step(det, tx))`` from the
    same converted weights: the per-task loss terms, the gradients (the
    JAX step's own, read back from Adam's first moment), and the
    parameters and batch statistics after the step, by the rules of
    ``tests/test_torch_train.py``, but for the backbone's gradients.

    There the reference itself is not stable to those rules: the same JAX
    step compiled with the example as a traced argument instead of a
    constant moves the backbone's gradients by 4e-4 to 1.2e-3 relative RMS
    per tensor (the 3D trunk's eight conv + batch-statistics BN + ReLU
    layers at random weights amplify rounding, as the flagship's trunk
    does), while the neck's and head's move by ~1e-6. The port lies as
    close to the constant compile as the traced compile does (measured
    ratio 0.95-1.35 per tensor), so each backbone gradient is held to 3x
    the reference's own spread in that tensor."""
    sys.path.insert(0, ROOT)
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    m, tc = tiny_centerpoint_cfg()
    ex = _step_example(rng, m, tc)
    assert all(int(k.sum()) > 0 for k in ex["mask"])
    jdet = jax_build(m, None, tc)
    v = _jax_init(jdet, 7, rng)
    lr_max, total = 3e-3, 1000
    tx = jax_opt(lr_max=lr_max, total_steps=total)
    step = jax_step(jdet, tx)
    # device arrays, as the CLI's batches are: the JAX loss indexes the
    # targets with a jnp index array
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    key = jax.random.PRNGKey(1)
    new_state, jmet = jax.jit(lambda s: step(s, jex, key))(
        create_train_state(v, tx))
    traced, _ = jax.jit(lambda s, e: step(s, e, key))(
        create_train_state(v, tx), jex)

    det = build_detector(m, None, tc, device="cpu")
    load_converted(det.module, v)
    opt = build_one_cycle_optimizer(det.module, lr_max, total)
    met = make_train_step(det, opt)(
        {k: [torch.from_numpy(a) for a in x] if isinstance(x, list)
         else torch.from_numpy(x) for k, x in ex.items()},
        torch.Generator().manual_seed(0))

    assert sorted(met) == sorted(jmet)
    # f32 forward in another summation order
    for k in ("det_loss", "hm_loss", "loc_loss"):
        assert len(met[k]) == len(jmet[k]) == 1
        np.testing.assert_allclose(float(met[k][0]), float(jmet[k][0]),
                                   rtol=1e-5, err_msg=k)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)

    b1 = np.float32(0.95)

    def jax_grads(state):
        return flax_to_torch({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) / (np.float32(1) - b1),
            state.opt_state.inner_state[1].mu)})

    want, other = jax_grads(new_state), jax_grads(traced)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    scale = min(1.0, 35.0 / float(met["grad_norm"]))
    params = dict(det.module.named_parameters())
    assert sorted(want) == sorted(params)
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in params.items():
        assert p.grad is not None, name
        g, r = p.grad.numpy() * scale, want[name].numpy()
        if name.startswith("backbone."):
            spread = rel(other[name].numpy(), r)
            assert rel(g, r) <= 3 * spread + 1e-5, (name, rel(g, r), spread)
            continue
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-5 * gmax,
                                   err_msg=name)

    lr0 = lr_max / 10.0

    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    sd = det.module.state_dict()
    assert sorted(after) == sorted(sd)
    n_loose = n_all = 0
    for k, r in after.items():
        got, r = sd[k].numpy(), r.numpy()
        if k not in params:
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        assert np.all(np.abs(got - r) <= 2 * lr0 * 1.01 + 1e-6), k
        g, gr = params[k].grad.numpy(), want[k].numpy()
        # Adam's first step is determined where the gradients agree in
        # sign and stand clear of its eps. In the backbone a step may also
        # differ where a gradient near eps moves by the reference's own
        # spread: such elements count as loose, as sign flips do.
        firm = (np.sign(g) == np.sign(gr)) & (np.abs(gr) > 1e-6)
        if k.startswith("backbone."):
            firm &= np.isclose(got, r, rtol=1e-6, atol=2e-6)
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_loose += int((~firm).sum())
        n_all += firm.size
    assert n_loose <= 0.01 * n_all


# ------------------------------------------------------------- entry points

_PORT_DIST_TEST = r"""
import json, sys
from partner_tpu_torch.tools import dist_test
(metrics, _), fps = dist_test.main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "fps": fps, "metrics": metrics}))
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
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc):
    out, err = proc.communicate(timeout=600)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run_jax(module, argv):
    """``tools/<module>.py`` main() in this process with ``argv``.

    The JAX train CLI's log flush calls ``float`` on every loss term, and
    the CenterPoint loss gives per-task lists: it raises a TypeError
    (ROADMAP.md §3, faults on the reference side). Its step is wrapped so
    that each list reaches the flush as the sum over the tasks, which for
    one task is the task's value; the step itself is unchanged."""
    import partner_tpu.train.train_state as jts

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    mod = __import__(module)
    orig, old_argv = jts.make_train_step, sys.argv

    def summing(det, tx):
        base = orig(det, tx)

        def step(state, ex, rng):
            state, met = base(state, ex, rng)
            return state, {k: sum(v) if isinstance(v, list) else v
                           for k, v in met.items()}

        return step

    jts.make_train_step, sys.argv = summing, [f"{module}.py"] + argv
    try:
        return mod.main()
    finally:
        jts.make_train_step, sys.argv = orig, old_argv


def load_pred(work_dir):
    with open(os.path.join(work_dir, "prediction.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("centerpoint_cli")
    rng = np.random.RandomState(11)
    info = write_three_class_infos(str(tmp / "infos.pkl"), rng)
    cfg = write_tiny_centerpoint_config(str(tmp / "cfg.py"), info, info,
                                        str(tmp))
    m, tc = tiny_centerpoint_cfg()
    v = _jax_init(jax_build(m, None, tc), 7, rng)

    class State:   # what save_checkpoint reads of a TrainState
        step, params, batch_stats, opt_state = 0, v["params"], \
            v["batch_stats"], {}

    save_checkpoint(str(tmp / "init"), State)
    ckpt = str(tmp / "init" / "latest")
    common = ["--max_points", str(MAX_POINTS)]
    procs = {
        "dist_test": port(["-c", _PORT_DIST_TEST, cfg, "--device", "cpu",
                           "--checkpoint", ckpt, "--work_dir",
                           str(tmp / "port_eval")] + common),
        "train": port(["-c", _PORT_TRAIN, cfg, "--device", "cpu",
                       "--work_dir", str(tmp / "port_train"),
                       "--batch_size", "2", "--total_steps", "2",
                       "--max_steps_per_epoch", "2", "--load_from",
                       ckpt] + common),
        "static_rpe": port(["-m", "partner_tpu_torch.tools.dist_test", cfg,
                            "--device", "cpu", "--checkpoint", ckpt,
                            "--static_rpe", "--work_dir",
                            str(tmp / "static")] + common),
    }
    jax_metrics, _ = run_jax("dist_test", [
        cfg, "--checkpoint", ckpt, "--work_dir", str(tmp / "jax_eval")]
        + common)
    run_jax("train", [cfg, "--work_dir", str(tmp / "jax_train"),
                      "--batch_size", "2", "--total_steps", "2",
                      "--max_steps_per_epoch", "2", "--mesh", "data=1",
                      "--load_from", ckpt] + common)
    return dict(tmp=tmp, jax_metrics=jax_metrics,
                res={k: finish(p) for k, p in procs.items()})


def _ok(runs, name):
    res = runs["res"][name]
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [], got["bad"]
    return got


def test_dist_test_matches_jax_cli(runs):
    """``dist_test --device cpu`` from the JAX checkpoint: every frame's
    kept boxes, labels and scores, and the 3-class Waymo metrics."""
    got = _ok(runs, "dist_test")
    jp = load_pred(runs["tmp"] / "jax_eval")
    tp = load_pred(runs["tmp"] / "port_eval")
    assert sorted(tp) == sorted(jp) == [f"frame{i}" for i in range(4)]
    for token in jp:
        j, t = jp[token], tp[token]
        assert len(t["scores"]) == len(j["scores"]) > 10, token
        np.testing.assert_array_equal(t["label_preds"], j["label_preds"])
        assert set(np.unique(t["label_preds"])) <= {0, 1, 2}
        np.testing.assert_allclose(t["box3d_lidar"], j["box3d_lidar"],
                                   rtol=0, atol=1e-4, err_msg=token)
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=0,
                                   atol=1e-5, err_msg=token)
    jm, tm = runs["jax_metrics"], got["metrics"]
    assert sorted(tm) == sorted(jm)
    for cls in ("Vehicle", "Pedestrian", "Cyclist"):
        assert f"AP/L1/{cls}" in tm and np.isfinite(tm[f"AP/L1/{cls}"])
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-6, (k, tm[k], jm[k])


def test_train_cli_steps_match_jax_cli(runs):
    """Two steps of each CLI from the same JAX checkpoint (``--load_from``):
    step 0 starts from the same weights and is held as the flagship CLI
    test holds it (1e-4 on the loss terms, 2e-3 on the gradient norm).
    Step 1 follows one Adam update at random weights, whose chaotic
    upstream gradients move the weights apart
    (``tests/test_torch_train_cli.py``): measured 0.07-0.1% on the loss terms
    and 6.4% on the gradient norm, which the backbone dominates; bounds
    1% and 25%."""
    assert _ok(runs, "train")["steps"] == 2

    def read(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    jm, pm = read(runs["tmp"] / "jax_train"), read(runs["tmp"] /
                                                   "port_train")
    assert [r["step"] for r in pm] == [r["step"] for r in jm] == [0, 1]
    for j, p, (tol, norm_tol) in zip(jm, pm, ((1e-4, 2e-3), (0.01, 0.25))):
        assert p["lr"] == pytest.approx(j["lr"], rel=1e-6)
        # the port logs a per-task term as a list (one task here); the
        # wrapped JAX step logs the task sum
        for k in ("det_loss", "hm_loss", "loc_loss"):
            assert len(p[k]) == 1 and np.isfinite(p[k][0]), (k, p[k])
            assert abs(p[k][0] - j[k]) <= tol * abs(j[k]), (j["step"], k)
        assert abs(p["loss"] - j["loss"]) <= tol * abs(j["loss"])
        assert abs(p["grad_norm"] - j["grad_norm"]) <= norm_tol * j[
            "grad_norm"]
    assert sorted(os.listdir(runs["tmp"] / "port_train")).count(
        "ckpt_00000002") == 1


def test_static_rpe_exits_on_centerpoint(runs):
    res = runs["res"]["static_rpe"]
    assert res.returncode != 0
    assert "has no such cache" in res.stderr
    assert not os.path.exists(runs["tmp"] / "static" / "prediction.pkl")


# ---------------------------------------------------------- build and refusals

@pytest.mark.parametrize("config", ZOO, ids=[os.path.basename(c)[:-3]
                                             for c in ZOO])
def test_every_waymo_centerpoint_config_builds(config):
    """Each Waymo CenterPoint config at its full width and grid, on the
    meta device (no memory): the point path's input width, the 3D trunk's
    256-wide BEV, one 3-class task with the config's heads."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.models.detectors import CenterPointDetector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, config))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    assert isinstance(det, CenterPointDetector)
    assert det.input_kind == "points"
    mod = det.module
    assert mod.grid_size == (1152, 2048, 40) and not mod.with_set_attention
    assert mod.backbone.out_features == 256
    c_in = cfg["model"]["backbone"]["num_input_features"] + 3
    assert tuple(mod.backbone.stem0_kernel.shape) == (c_in, 32)
    heads = [n for n, _ in mod.bbox_head.task0.heads]
    assert heads == sorted(list(cfg["model"]["bbox_head"]["common_heads"])
                           + ["hm"])
    assert det.code_weights == tuple(cfg["model"]["bbox_head"][
        "code_weights"])


def _model(**changes):
    from partner_tpu_torch.utils.config import load_config

    m = dict(load_config(os.path.join(ROOT, CENTERPOINT))["model"])
    m.update(changes)
    return m


REFUSALS = {
    "seg-head": (dict(seg_head=dict(type="SegHead", num_classes=4)),
                 NotImplementedError, "seg_head.py"),
    "no-bbox-head": (dict(bbox_head=None), NotImplementedError,
                     "seg_head.py"),
    "pfn-reader": (dict(reader=dict(type="PillarFeatureNet",
                                    num_input_features=7)),
                   NotImplementedError, "pillar.py"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_voxelnet_parts_not_ported_raise(case):
    from partner_tpu_torch.models import build_detector

    changes, err, item = REFUSALS[case]
    with pytest.raises(err, match=item):
        build_detector(_model(**changes), device="meta")


def test_voxelnet_options_not_ported_raise():
    """per_class_nms, double_flip and the E2E head's block route each
    raise naming their ROADMAP item."""
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_centerpoint_cfg()
    with pytest.raises(ValueError, match="use_block_kernel"):
        build_detector(m, None, tc, device="meta", use_block_kernel=True)
    pts, mask = synthetic_points(np.random.RandomState(0), m["bbox_head"][
        "voxel_generator"]["range"], 100, 128)
    ex = {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(
        mask)}
    for key, item in (("per_class_nms", "batched_rotated_nms"),
                      ("double_flip", "double_flip_average")):
        det = build_detector(m, None, dict(tc, **{key: True}), device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            det.predict(ex)
