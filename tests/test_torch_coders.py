"""The box-coder family behind ``CODER_CONFIG["type"]``: the port against
the JAX package.

Each of the seven coders' ``encode``, ``get_delta`` and ``decode`` on 64
numpy-seeded boxes (dy >= dx) and predictions, in both rectify modes where
the class has one and both angle modes where it allows them; every raise
site of the JAX package raising in the port too. Then the tiny PARTNER
detector under three variant coders, with the JAX weights converted:
``predict``'s kept boxes, one float32 train step's loss terms and
assignment, and ``dist_test`` and the train CLI under a polar coder.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from torch_port_fixtures import (TINY_GRID, drawn_init, load_converted,
                                 randomize, synthetic_points, tiny_frame_cfg,
                                 write_tiny_eval_config,
                                 write_tiny_train_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)   # float32, both packages
TEMPLATE = [4.5, 2.0, 1.6]         # a Waymo vehicle's dims
ANCHORS = [[4.5, 2.0, 1.6], [0.8, 0.8, 1.7]]
# the variant coders the detector runs under (with the test_cfg rectify
# that pairs with each)
DETECTOR_CODERS = {
    "polar-rectify": dict(type="CenterCoderPolar", rectify=True),
    "polar-sig": dict(type="CenterCoderPolarSIG"),
    "tp": dict(type="CenterCoderTP", templates_box=TEMPLATE),
}


def _boxes(rng, n=64):
    """(n, 7) float32 boxes with dy >= dx (det3d's convention)."""
    dx = rng.uniform(0.4, 3.0, n)
    return np.stack([
        rng.uniform(-70, 70, n), rng.uniform(-70, 70, n),
        rng.uniform(-2, 3, n), dx, dx * rng.uniform(1.0, 3.0, n),
        rng.uniform(0.5, 4.0, n), rng.uniform(-np.pi, np.pi, n)],
        1).astype(np.float32)


def _preds(rng, code_size, n=64):
    """Encoded predictions: absolute x/y, unit-scale other columns."""
    p = rng.normal(0, 1, (n, code_size)).astype(np.float32)
    p[:, :2] = rng.uniform(-70, 70, (n, 2))
    return p


# (type, constructor kwargs): every type in both rectify modes where it
# has one; MTTP has none
CODER_CASES = [
    (kind, dict(kw, rectify=rectify))
    for kind, kw in (("CenterCoder", {}), ("CenterCoderV2", {}),
                     ("CenterCoderPolar", {}),
                     ("CenterCoderPolarTP", dict(template_ratio=2.2)),
                     ("CenterCoderPolarSIG", {}),
                     ("CenterCoderTP", dict(templates_box=TEMPLATE)))
    for rectify in (False, True)] + [
    ("CenterCoderMTTP", dict(tmp_box=ANCHORS))]


def _case_id(case):
    kind, kw = case
    return kind + ("-rectify" if kw.get("rectify") else "")


def _build(kind, kw, sincos):
    from partner_tpu.core.center_coder import build_coder as jbuild
    from partner_tpu_torch.core.center_coder import build_coder

    cfg = dict(kw, type=kind, encode_angle_by_sincos=sincos)
    return jbuild(cfg), build_coder(cfg)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **TOL)


@pytest.mark.parametrize("sincos", [True, False], ids=["sincos", "angle"])
@pytest.mark.parametrize("case", CODER_CASES, ids=_case_id)
def test_coder_matches_jax(case, sincos):
    """encode, get_delta and decode within 1e-5 abs + 1e-5 rel; where the
    JAX coder raises (non-sincos polar or V2 deltas, V2's rectified
    decode), the port raises the same error."""
    kind, kw = case
    jc, tc = _build(kind, kw, sincos)
    rng = np.random.RandomState(7)
    boxes = _boxes(rng)
    preds = _preds(rng, 8 if sincos else 7)
    tb, tp = torch.from_numpy(boxes), torch.from_numpy(preds)
    assert type(tc).__name__ == kind and tc.code_size == jc.code_size
    _close(tc.encode(tb), jc.encode(boxes), "encode")
    grid = {}
    if kind == "CenterCoderV2" and kw["rectify"]:
        xy = rng.uniform(-70, 70, (2, 64)).astype(np.float32)
        grid = dict(x_grid=xy[0], y_grid=xy[1])
    for name, args, targs in (
            ("get_delta", (boxes, preds), (tb, tp)),
            ("decode", (preds,), (tp,))):
        kwargs = grid if name == "get_delta" else {}
        try:
            want = getattr(jc, name)(*args, **kwargs)
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                getattr(tc, name)(*targs, **{k: torch.from_numpy(v)
                                             for k, v in kwargs.items()})
            continue
        got = getattr(tc, name)(*targs, **{k: torch.from_numpy(v)
                                           for k, v in kwargs.items()})
        _close(got, want, name)
    if kind == "CenterCoderMTTP":   # the second task's anchor
        _close(tc.encode(tb, task_id=1), jc.encode(boxes, task_id=1),
               "encode task 1")
        _close(tc.decode(tp, task_id=1), jc.decode(preds, task_id=1),
               "decode task 1")
        _close(tc.get_delta(tb, tp, task_id=1),
               jc.get_delta(boxes, preds, task_id=1), "get_delta task 1")


@pytest.mark.parametrize("sincos", [True, False], ids=["sincos", "angle"])
def test_encode_with_rois_matches_jax(sincos):
    jc, tc = _build("CenterCoderV2", {}, sincos)
    rng = np.random.RandomState(8)
    boxes, rois = _boxes(rng), _boxes(rng)
    _close(tc.encode_with_rois(torch.from_numpy(boxes),
                               torch.from_numpy(rois)),
           jc.encode_with_rois(boxes, rois), "encode_with_rois")


def _raise_cases():
    """{id: (exception, fn(a center_coder module, array maker))}."""
    rng = np.random.RandomState(9)
    boxes, preds = _boxes(rng, 8), _preds(rng, 8, 8)
    p7 = preds[:, :7]
    return {
        "V2 delta not sincos": (NotImplementedError, lambda cc, a: cc.
                                CenterCoderV2(encode_angle_by_sincos=False)
                                .get_delta(a(boxes), a(p7))),
        "V2 rectified delta without the grid": (
            AssertionError, lambda cc, a: cc.CenterCoderV2(rectify=True)
            .get_delta(a(boxes), a(preds))),
        "V2 rectified decode": (NotImplementedError, lambda cc, a: cc.
                                CenterCoderV2(rectify=True).decode(a(preds))),
        "polar delta not sincos": (
            NotImplementedError, lambda cc, a: cc.CenterCoderPolar(
                encode_angle_by_sincos=False).get_delta(a(boxes), a(p7))),
        "polar TP delta not sincos": (
            NotImplementedError, lambda cc, a: cc.CenterCoderPolarTP(
                template_ratio=2.0, encode_angle_by_sincos=False)
            .get_delta(a(boxes), a(p7))),
        "polar SIG delta not sincos": (
            NotImplementedError, lambda cc, a: cc.CenterCoderPolarSIG(
                encode_angle_by_sincos=False).get_delta(a(boxes), a(p7))),
        "polar TP without a ratio": (
            AssertionError, lambda cc, a: cc.CenterCoderPolarTP()),
        "TP encode without a template": (
            AssertionError, lambda cc, a: cc.CenterCoderTP().encode(
                a(boxes))),
        "TP decode without a template": (
            AssertionError, lambda cc, a: cc.CenterCoderTP().decode(
                a(preds))),
        "MTTP without anchors": (
            AssertionError, lambda cc, a: cc.CenterCoderMTTP()),
        "unknown type": (KeyError, lambda cc, a: cc.build_coder(
            dict(type="CenterCoderXYZ"))),
    }


RAISES = _raise_cases()


@pytest.mark.parametrize("case", sorted(RAISES))
def test_every_raise_site_raises_in_both(case):
    from partner_tpu.core import center_coder as jcc
    from partner_tpu_torch.core import center_coder as tcc

    exc, fn = RAISES[case]
    with pytest.raises(exc):
        fn(jcc, np.asarray)
    with pytest.raises(exc):
        fn(tcc, torch.from_numpy)


def _with_coder(m, coder):
    m = dict(m)
    m["bbox_head"] = dict(m["bbox_head"], CODER_CONFIG=dict(
        m["bbox_head"]["CODER_CONFIG"], **coder))
    return m


def test_build_refuses_a_multi_anchor_mttp_and_mismatched_rectify():
    from partner_tpu.core.center_coder import CenterCoder as JCoder
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.models.e2e_head import decode_flat_preds as jdecode
    from partner_tpu_torch.core.center_coder import CenterCoder
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.models.e2e_head import decode_flat_preds

    m, tc = tiny_frame_cfg()
    bad = _with_coder(m, dict(type="CenterCoderMTTP", tmp_box=ANCHORS))
    with pytest.raises(ValueError, match="multiple task anchors"):
        jax_build(bad, None, tc)
    with pytest.raises(ValueError, match="multiple task anchors"):
        build_detector(bad, None, tc, device="cpu")
    one = _with_coder(m, dict(type="CenterCoderMTTP", tmp_box=ANCHORS[:1]))
    assert type(build_detector(one, None, tc, device="cpu").coder
                ).__name__ == "CenterCoderMTTP"
    flat = {"pred_logits": np.zeros((1, 4, 1), np.float32),
            "pred_boxes": np.zeros((1, 4, 8), np.float32)}
    with pytest.raises(ValueError, match="rectify"):
        jdecode(flat, JCoder(), rectify=True)
    with pytest.raises(ValueError, match="rectify"):
        decode_flat_preds({k: torch.from_numpy(v) for k, v in flat.items()},
                          CenterCoder(), rectify=True)


# ------------------------------------------------------- the tiny detector

@pytest.fixture(scope="module")
def weights():
    """The tiny flagship config, its JAX variables (drawn, then every
    norm randomized), a synthetic sweep, and a train batch of two samples
    (``chip_smoke.train_example``: numpy and the port's vote maps)."""
    from chip_smoke import train_example
    from partner_tpu.models import build_detector as jax_build

    rng = np.random.RandomState(0)
    m, tc = tiny_frame_cfg()
    m["neck"] = dict(m["neck"], set_drop=0.0, set_attn_drop=0.0,
                     set_drop_path=0.0)
    pr = m["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_points(rng, pr, 2000, 2400)
    jdet = jax_build(m, None, tc)
    v = randomize(drawn_init(jdet.module.init, rng, {
        "points": pts[:, :64], "points_mask": mask[:, :64]}, train=False),
        rng)
    return dict(m=m, tc=tc, v=v, ex={"points": pts, "points_mask": mask},
                step_ex=train_example(rng, pr, TINY_GRID, 2, 1200, 2048, 8))


def _pair(weights, coder):
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    m = _with_coder(weights["m"], coder)
    tc = dict(weights["tc"], rectify=coder.get("rectify", False))
    det = build_detector(m, None, tc, device="cpu")
    load_converted(det.module, weights["v"])
    return jax_build(m, None, tc), det


@pytest.fixture(scope="module")
def jax_maps(weights):
    """The JAX eval-mode head maps of the sweep (coder-independent), for
    ``predict`` under every coder."""
    import jax

    from partner_tpu.models import build_detector as jax_build

    jdet = jax_build(weights["m"], None, weights["tc"])
    return jax.jit(lambda v, e: jdet.module.apply(v, e, train=False))(
        weights["v"], weights["ex"])


@pytest.mark.parametrize("coder", sorted(DETECTOR_CODERS))
def test_predict_keeps_jax_boxes(weights, jax_maps, coder):
    """``E2EDetector.predict`` under the coder against JAX's ``predict``
    (its own code, jitted, on the JAX maps of the same weights: the
    network does not depend on the coder): the same kept indices in the
    same order and labels, boxes within 1e-4 (abs + rel), scores within
    1e-5."""
    import jax

    jdet, det = _pair(weights, DETECTOR_CODERS[coder])
    jdet.module = type("Maps", (), {"apply": staticmethod(
        lambda *a, **k: jax_maps)})()
    jout = {k: np.asarray(x) for k, x in
            jax.jit(jdet.predict)(weights["v"], weights["ex"]).items()}
    out = det.predict({k: torch.from_numpy(a)
                       for k, a in weights["ex"].items()})
    out = {k: x.numpy() for k, x in out.items()}
    assert out["mask"].sum() > 10
    np.testing.assert_array_equal(out["mask"], jout["mask"])
    np.testing.assert_array_equal(out["label_preds"], jout["label_preds"])
    m = jout["mask"]
    # decode of maps that agree to ~1e-5 (exp/atan2/cos in f32); boxes
    # reach ~75 m, as in test_torch_frame
    np.testing.assert_allclose(out["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["scores"][m], jout["scores"][m], rtol=0,
                               atol=1e-5)


def _port_step(det, ex, monkeypatch):
    """One port ``make_train_step`` step -> (metrics as floats, the
    matcher's assignment)."""
    from partner_tpu_torch.losses import set_crit
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    seen = []
    record = set_crit.assign_auction
    monkeypatch.setattr(set_crit, "assign_auction",
                        lambda *a, **k: seen.append(record(*a, **k))
                        or seen[-1])
    met = make_train_step(det, build_one_cycle_optimizer(
        det.module, 3e-3, 1000))(
            {k: torch.from_numpy(a) for k, a in ex.items()},
            torch.Generator().manual_seed(0))
    monkeypatch.undo()
    return {k: float(v) for k, v in met.items()}, seen[0].numpy()


def _jax_step(jdet, ex, preds):
    """JAX's ``make_train_step``, jitted, with the detector's forward
    giving ``preds`` (JAX's train-mode maps of the same weights, batch and
    dropout key: the network does not depend on the coder, so one forward
    compile serves every coder) -> (its metrics as floats, the auction
    matcher's assignment inside it)."""
    import jax

    from partner_tpu.losses import set_crit as jset_crit
    from partner_tpu.train.optim import build_one_cycle_optimizer as jopt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jstep

    seen = []
    assign = jset_crit.assign_auction

    def recorded(*args, **kwargs):
        out = assign(*args, **kwargs)
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), out)
        return out

    jdet.forward = lambda *a, **k: (preds, {})
    tx = jopt(lr_max=3e-3, total_steps=1000)
    step = jstep(jdet, tx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jset_crit, "assign_auction", recorded)
        # the maps stand for the network, so the step holds no parameter
        # (its optimizer over every leaf would compile for ~7 s)
        _, met = jax.jit(lambda s: step(s, ex, jax.random.PRNGKey(1)))(
            create_train_state({"params": {}, "batch_stats": {}}, tx))
        met = {k: float(x) for k, x in met.items()}
    assert len(seen) == 1
    return met, seen[0]


@pytest.fixture(scope="module")
def jax_train_maps(weights):
    """JAX's train-mode head maps of the step's batch (drop rates 0,
    dropout key 1)."""
    import jax

    from partner_tpu.models import build_detector as jax_build

    jdet = jax_build(weights["m"], None, weights["tc"])
    ex = weights["step_ex"]
    return jax.jit(lambda v: jdet.forward(
        v, ex, jax.random.PRNGKey(1), train=True)[0])(weights["v"])


@pytest.mark.parametrize("coder", sorted(DETECTOR_CODERS))
def test_train_step_matches_jax(weights, jax_train_maps, coder,
                                monkeypatch):
    """One float32 step of the port's ``make_train_step`` (b = 2, drop
    rates 0) against JAX's (:func:`_jax_step`): the assignment equal,
    ``num_matched`` equal, the loss terms within 1e-5 relative
    (``test_torch_train``'s bound, where the whole network's step is held
    against JAX's under the default coder)."""
    jdet, det = _pair(weights, DETECTOR_CODERS[coder])
    want, jassigned = _jax_step(jdet, weights["step_ex"], jax_train_maps)
    got, assigned = _port_step(det, weights["step_ex"], monkeypatch)
    np.testing.assert_array_equal(assigned, jassigned)
    assert int(got["num_matched"]) == int(want["num_matched"]) > 0
    for k in ("loss", "loss_ce", "loss_bbox", "loss_vote", "loss_vote_cls",
              "loss_iou"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert np.isfinite(got["grad_norm"]) and got["grad_norm"] > 0


# ------------------------------------------------------------ the CLIs

POLAR_CLI = """
bbox_head["CODER_CONFIG"].update(type="CenterCoderPolar", rectify=True)
test_cfg["rectify"] = True
"""


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, weights):
    """dist_test of the tiny config under ``CenterCoderPolar(rectify)``
    from one JAX checkpoint: the JAX CLI and the port's, both in this
    process; then two port train-CLI steps of the same config with
    ``ClosureHook``s (instances and a dict entry) in
    ``log_config.hooks``."""
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint
    from partner_tpu_torch.tools import dist_test, train
    from test_data_pipeline import make_waymo_infos

    tmp = tmp_path_factory.mktemp("coder_cli")
    info = make_waymo_infos(tmp, n=2, seed=6)
    cfg = write_tiny_eval_config(str(tmp / "cfg.py"), info, str(tmp))
    with open(cfg, "a") as f:
        f.write(POLAR_CLI)
    m, tc, v = weights["m"], weights["tc"], weights["v"]

    class State:   # what save_checkpoint reads of a TrainState
        step, params, batch_stats, opt_state = 0, v["params"], \
            v["batch_stats"], {}

    save_checkpoint(str(tmp / "ckpt"), State)
    common = ["--max_points", "5000", "--checkpoint",
              str(tmp / "ckpt" / "latest")]
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import dist_test as jax_dist_test

    def template(self, rng, example):
        # the variables' shapes only: the checkpoint replaces every value
        # (a jitted flax init compiles threefry draws, ~10 s)
        shapes = jax.eval_shape(lambda: self.module.init(
            rng, example, train=False))
        return jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(jax_build(m, None, tc)), "init", template)
        mp.setattr(sys, "argv", ["dist_test.py", cfg, "--work_dir",
                                 str(tmp / "jax")] + common)
        jax_dist_test.main()
    dist_test.main([cfg, "--device", "cpu", "--work_dir",
                    str(tmp / "port")] + common)

    tcfg = write_tiny_train_config(str(tmp / "train_cfg.py"), info,
                                   str(tmp))
    log = str(tmp / "stages.txt")
    with open(tcfg, "a") as f:
        f.write(POLAR_CLI + f"""
from partner_tpu_torch.train.hooks import ClosureHook

def _note(stage):
    def fn(runner):
        with open({log!r}, "a") as f:
            f.write(f"{{stage}} {{runner.iter}} {{runner.epoch}} "
                    f"{{type(runner.model).__name__}} "
                    f"{{runner.outputs is not None}}\\n")
    return fn

log_config["hooks"] += [
    ClosureHook(stage, _note(stage))
    for stage in ("before_run", "after_iter", "after_run")] + [
    dict(type="ClosureHook", fn_name="after_epoch", fn=_note("after_epoch"))]
""")
    last = train.main([tcfg, "--work_dir", str(tmp / "train"), "--device",
                       "cpu", "--batch_size", "1", "--total_steps", "2",
                       "--max_points", "5000"])
    with open(log) as f:
        stages = f.read().split("\n")[:-1]
    return dict(tmp=tmp, last=last, stages=stages)


def test_dist_test_with_a_polar_coder_gives_jax_boxes(cli_runs):
    def load(d):
        with open(cli_runs["tmp"] / d / "prediction.pkl", "rb") as f:
            return pickle.load(f)

    jp, tp = load("jax"), load("port")
    assert sorted(tp) == sorted(jp) == ["frame0", "frame1"]
    for token in jp:
        j, t = jp[token], tp[token]
        assert len(t["scores"]) == len(j["scores"]) > 10, token
        np.testing.assert_array_equal(t["label_preds"], j["label_preds"])
        # as test_predict_keeps_jax_boxes: polar decode of ~75 m boxes
        np.testing.assert_allclose(t["box3d_lidar"], j["box3d_lidar"],
                                   rtol=1e-4, atol=1e-4, err_msg=token)
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=0,
                                   atol=1e-5, err_msg=token)


def test_train_cli_calls_closure_hooks_at_their_stages(cli_runs):
    """Two steps (one epoch of two one-frame batches) under the polar
    coder: each hook at its stage, in order, with the loop's state and,
    after a step, its metrics."""
    assert cli_runs["last"] == 2
    assert cli_runs["stages"] == [
        "before_run 0 0 E2EDetector False",
        "after_iter 0 0 E2EDetector True",
        "after_iter 1 0 E2EDetector True",
        "after_epoch 2 1 E2EDetector False",
        "after_run 2 1 E2EDetector False"]
