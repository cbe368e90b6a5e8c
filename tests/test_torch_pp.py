"""The Waymo PointPillars detectors in partner_tpu_torch against the JAX
package (CPU).

Both one-stage configs (``configs/waymo/pp/waymo_centerpoint_pp_two_*
pfn_stride1_3x.py``: ``PointPillars``, the two-layer ``PillarFeatureNet``,
``RPN``, ``CenterHead`` at stride 1) cut to a 64 x 64 pillar grid, PFN
filters [16, 16] and a narrow RPN, at a pillar capacity the batch
overflows: the pillar slots and the canvas of ``encode_canvas``, the head
maps and the kept NMS indices of ``predict``, one train step's loss terms,
gradients, parameters and statistics, the cuboid Waymo data path in val
and in train mode, and both CLIs from one JAX checkpoint (``dist_test``
with the 3- and 2-class Waymo metrics, two train steps, a resume from the
JAX run's ``state.pkl``, ``dist_test`` from the port run's checkpoint). One JAX detector, its variables and its jitted
functions are shared per config. At full width, each config is built on
the meta device with JAX's parameter count.
"""

import copy
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_centerpoint import (_PORT_DIST_TEST, _PORT_TRAIN, finish,
                                    load_pred, port, run_jax)
from torch_port_fixtures import (PP, PP_CONFIGS, PP_PILLARS, drawn_init,
                                 load_converted, pp_points, randomize,
                                 tiny_pp_cfg, write_three_class_infos,
                                 write_tiny_pp_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS, N_ROWS = 4000, 4800
MAX_POINTS = 6000     # the CLIs' point buffer


def batch_of_two(seed):
    """Two cuboid sweeps (the second with twins) in one (2, N_ROWS, 7)
    buffer."""
    rng = np.random.RandomState(seed)
    pr = tiny_pp_cfg()[0]["bbox_head"]["voxel_generator"]["range"]
    a, ma = pp_points(rng, pr, N_POINTS, N_ROWS)
    b, mb = pp_points(rng, pr, N_POINTS - 500, N_ROWS, dup=800)
    return np.concatenate([a, b]), np.concatenate([ma, mb])


@pytest.fixture(scope="module", params=list(PP_CONFIGS))
def pp(request):
    """One config in both packages from the same drawn variables."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_pp_cfg(PP_CONFIGS[request.param])
    pts, mask = batch_of_two(0)
    ex = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(1)
    v = randomize(drawn_init(jdet.module.init, rng, ex, train=False), rng)
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    return dict(name=request.param, m=m, tc=tc, jdet=jdet, v=v, tdet=tdet,
                ex=ex, tex={"points": torch.from_numpy(pts),
                            "points_mask": torch.from_numpy(mask)})


def test_encode_canvas_overflowed_slots_bit_equal(pp):
    """Batch 2 over a capacity both sweeps overflow: each row's pillar
    slot, the pillars' coords and mask bit-equal to the JAX package's
    ``dynamic_voxelize``; the canvas within float32 rounding."""
    from partner_tpu.models.pillar import PointPillarsModule
    from partner_tpu.ops.voxelize import dynamic_voxelize as jax_voxelize

    jm, tm = pp["jdet"].module, pp["tdet"].module
    vs = jnp.asarray([jm.voxel_size[0], jm.voxel_size[1],
                      jm.pc_range[5] - jm.pc_range[2]], jnp.float32)
    want = jax.vmap(lambda p, m: jax_voxelize(
        p, m, vs, jnp.asarray(jm.pc_range, jnp.float32),
        (jm.grid_size[0], jm.grid_size[1], 1), max_voxels=PP_PILLARS,
        return_point_voxel=True))(pp["ex"]["points"], pp["ex"]["points_mask"])
    got = tm.pillarize(pp["tex"]["points"], pp["tex"]["points_mask"])
    assert bool(got["mask"].all())        # both samples overflow
    assert int((got["point_voxel"] == PP_PILLARS).sum()) > 200
    for k in ("point_voxel", "coords", "mask", "num_points"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    jcanvas = np.asarray(jax.jit(lambda v, p, m: jm.apply(
        v, p, m, False, method=PointPillarsModule.encode_canvas))(
        pp["v"], pp["ex"]["points"], pp["ex"]["points_mask"]))
    tm.eval()
    with torch.no_grad():
        canvas = tm.encode_canvas(pp["tex"]["points"],
                                  pp["tex"]["points_mask"]).numpy()
    assert canvas.shape == jcanvas.shape == (2, 64, 64, 16)
    assert 0.9 * 2 * PP_PILLARS < np.count_nonzero(canvas.any(-1)) <= \
        2 * PP_PILLARS
    np.testing.assert_allclose(canvas, jcanvas, rtol=1e-5,
                               atol=1e-5 * np.abs(jcanvas).max())


@pytest.fixture(scope="module")
def frames(pp):
    """(JAX maps, JAX detections, port maps, port detections) as numpy."""
    jdet, v, ex = pp["jdet"], pp["v"], pp["ex"]
    jmaps = jax.jit(lambda v, e: jdet.module.apply(v, e, train=False))(v, ex)
    jout = jax.jit(jdet.predict)(v, ex)
    with torch.no_grad():
        tmaps = pp["tdet"].module(pp["tex"])
    tout = pp["tdet"].predict(pp["tex"])
    as_np = lambda d: {k: np.asarray(x) for k, x in d.items()}
    return (as_np(jmaps["det_preds"][0]), as_np(jout),
            as_np(tmaps["det_preds"][0]), as_np(tout))


def test_frame_head_maps_match_jax(pp, frames):
    jmaps, _, tmaps, _ = frames
    assert list(tmaps) == list(jmaps) == ["dim", "height", "hm", "reg",
                                          "rot"]
    n_cls = 3 if pp["name"] == "three-class" else 2
    assert tmaps["hm"].shape == (2, 64, 64, n_cls)
    for k in jmaps:
        # PFN, RPN and head in f32, another summation order: ~1e-6
        # measured against maps of magnitude ~1-6
        np.testing.assert_allclose(tmaps[k], jmaps[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_frame_detections_match_jax(pp, frames):
    _, jout, _, tout = frames
    assert tout["mask"].shape == jout["mask"].shape == (2, 64)
    assert tout["box3d_lidar"].shape[-1] == 7
    assert tout["mask"].sum() > 40
    # the kept set, its order and labels are exact
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    m = jout["mask"]
    np.testing.assert_allclose(tout["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                               rtol=1e-5, atol=1e-6)


def test_train_step_matches_jax(pp):
    """One step of the tiny config at batch 2 with center targets from the
    port's assigner, against ``jax.jit(make_train_step)`` from the same
    variables: the loss terms and the gradient norm, the gradients (JAX's
    own, read back from Adam's first moment), and the parameters and
    statistics after the step. The PFN's train-mode BatchNorm takes its
    statistics over both samples' points, as JAX's does.

    The gradients are held per tensor, relative RMS: 1e-4 for the heads'
    output convs, which no ReLU follows (measured <= 1e-5), and 5e-2 for
    every tensor behind a ReLU. At stride 1 a few of the ReLU units the
    loss reaches sit within float32 rounding of 0 (one at 3.5e-6 in a
    ``reg`` head conv for one example seed), and the two packages'
    summation orders put such a unit on opposite sides: measured 0.4-1.7%
    on the tensors behind it over three example seeds. The PFN's gradient
    rule itself, the even split among tied maxima, is held at 1e-4 in
    ``tests/test_torch_pillars.py``."""
    import chip_smoke
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step
    from partner_tpu_torch.utils.config import load_config

    m, tc = pp["m"], pp["tc"]
    train_cfg = load_config(os.path.join(ROOT, PP))["train_cfg"]
    ex = chip_smoke.pp_train_example(np.random.RandomState(2), m, train_cfg,
                                     2, 3000, 3600, 16)
    assert all(int(k.sum()) >= 8 for k in ex["mask"][0])
    lr_max, total = 3e-3, 1000
    tx = jax_opt(lr_max=lr_max, total_steps=total)
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    new_state, jmet = jax.jit(lambda s: jax_step(pp["jdet"], tx)(
        s, jex, jax.random.PRNGKey(1)))(create_train_state(pp["v"], tx))

    det = build_detector(m, None, tc, device="cpu")
    load_converted(det.module, pp["v"])
    opt = build_one_cycle_optimizer(det.module, lr_max, total)
    met = make_train_step(det, opt)(
        {k: [torch.from_numpy(a) for a in x] if isinstance(x, list)
         else torch.from_numpy(x) for k, x in ex.items()},
        torch.Generator().manual_seed(0))

    assert sorted(met) == sorted(jmet)
    for k in ("det_loss", "hm_loss", "loc_loss"):
        assert len(met[k]) == len(jmet[k]) == 1
        np.testing.assert_allclose(float(met[k][0]), float(jmet[k][0]),
                                   rtol=1e-5, err_msg=k)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)

    b1 = np.float32(0.95)
    want = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) / (np.float32(1) - b1),
        new_state.opt_state.inner_state[1].mu)})
    scale = min(1.0, 35.0 / float(met["grad_norm"]))
    params = dict(det.module.named_parameters())
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        g, r = p.grad.numpy() * scale, want[name].numpy()
        assert np.linalg.norm(r) > 0, name
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel <= (1e-4 if name.split(".")[-2].endswith("_out")
                       else 5e-2), (name, rel)

    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    sd = det.module.state_dict()
    assert sorted(after) == sorted(sd)
    lr0 = lr_max / 10.0
    n_loose = n_all = 0
    for k, r in after.items():
        got, r = sd[k].numpy(), r.numpy()
        if k not in params:
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        assert np.all(np.abs(got - r) <= 2 * lr0 * 1.01 + 1e-6), k
        if not k.split(".")[-2].endswith("_out"):
            continue   # its gradient is held above; Adam's step scales it
        # Adam's first step is determined where the gradient stands clear
        # of its eps (many of these heads' gradients do not: the targets
        # are sparse) and held where the signs agree; a sign that
        # differs there counts as loose
        g, gr = params[k].grad.numpy(), want[k].numpy()
        clear = np.abs(gr) > 1e-6
        firm = clear & (np.sign(g) == np.sign(gr))
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_loose += int((clear & ~firm).sum())
        n_all += int(clear.sum())
    assert n_all > 1000 and n_loose <= 0.01 * n_all


# ------------------------------------------------------------- data path

def _data_cfg(mode, info, root):
    from partner_tpu_torch.utils.config import load_config

    ds = copy.deepcopy(load_config(os.path.join(ROOT, PP))["data"][mode])
    ds.update(info_path=info, root_path=root)
    return ds


@pytest.mark.parametrize("mode", ["val", "train"])
def test_cuboid_waymo_batches_bit_equal(tmp_path, mode):
    """The config's pipeline in both packages on the same infos: 5-feature
    Waymo points to the cuboid [x, y, z, i, e, rho, phi], the 468 x 468
    grid's metadata, and in train mode the rotation, scaling and shuffle
    drawn from one seed and the center targets at stride 1 (no GT-AUG),
    collated in pairs."""
    import partner_tpu.data as jdata
    from partner_tpu.data.collate import collate as jcollate
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.collate import collate as tcollate

    info = write_three_class_infos(str(tmp_path / "infos.pkl"),
                                   np.random.RandomState(7), upper=True)
    ds = _data_cfg(mode, info, str(tmp_path))
    np.random.seed(21)
    jds = jdata.build_dataset(copy.deepcopy(ds))
    tds = tdata.build_dataset(copy.deepcopy(ds),
                              dict(rng=np.random.RandomState(21)))
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    assert len(titems) == len(jitems) == 4
    keys = ["points", "points_mask", "grid_size", "pc_range", "voxel_size"]
    if mode == "train":
        keys += ["hm", "anno_box", "ind", "mask", "cat"]
        assert all(int(t["mask"][0].sum()) >= 3 for t in titems)
    for i in range(0, 4, 2):
        j = jcollate(jitems[i:i + 2], max_points=MAX_POINTS)
        t = tcollate(titems[i:i + 2], max_points=MAX_POINTS)
        assert sorted(t) == sorted(j)
        assert t["points"].shape[-1] == 7
        np.testing.assert_array_equal(t["grid_size"], [468, 468, 1])
        for k in keys:
            for jt, tt in (zip(j[k], t[k]) if isinstance(j[k], list)
                           else [(j[k], t[k])]):
                assert tt.dtype == jt.dtype, k
                np.testing.assert_array_equal(tt, jt, err_msg=k)
        assert t["metadata"] == j["metadata"]
    if mode == "train":   # the points moved: rotated, scaled, shuffled
        with open(info, "rb") as f:
            raw = pickle.load(f)[0]["points"]
        assert not np.allclose(titems[0]["points"][:10, :3], raw[:10, :3])


# ---------------------------------------------------------- entry points

# the port's dist_test with the evaluator's loader at one thread
_PORT_DIST_TEST_ONE_THREAD = r"""
from partner_tpu_torch.eval import evaluator
_orig = evaluator.build_dataloader
evaluator.build_dataloader = lambda ds, bs, **kw: _orig(
    ds, bs, **dict(kw, workers_per_gpu=1))
""" + _PORT_DIST_TEST


def _jax_dist_test_one_thread(argv):
    """The JAX ``dist_test`` CLI in this process with its evaluator's
    loader at one thread."""
    import partner_tpu.data as jdata

    orig = jdata.build_dataloader
    jdata.build_dataloader = lambda ds, bs, **kw: orig(
        ds, bs, **dict(kw, workers_per_gpu=1))
    try:
        return run_jax("dist_test", argv)
    finally:
        jdata.build_dataloader = orig


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each CLI of both packages from one JAX checkpoint of the tiny
    3-class config (the port's in fresh processes, started first), and
    the 2-class ``dist_test`` of each; then the port's train CLI resumed
    from the JAX run's checkpoint for a third step. Both packages'
    ``dist_test`` of the JAX checkpoint run their loader at one thread,
    so no loader thread computes beside the model while the frames that
    are compared are predicted, and the frames come in order (a loaded
    whole run once moved a box of the 3-class run by 2.5e-4 against the
    1e-4 bound; alone, and twice under ten busy processes, the two
    packages' boxes stay within 1.24e-5, and the port's are bit-equal at
    1, 2 and 4 intra-op threads)."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("pp_cli")
    rng = np.random.RandomState(11)
    info = write_three_class_infos(str(tmp / "infos.pkl"), rng, upper=True)
    cfgs = {name: write_tiny_pp_config(str(tmp / f"{name}.py"), info, info,
                                       str(tmp), config=c)
            for name, c in PP_CONFIGS.items()}
    ckpts = {}
    for name, c in PP_CONFIGS.items():
        m, tc = tiny_pp_cfg(c)
        ex = {"points": np.zeros((1, 64, 7), np.float32),
              "points_mask": np.zeros((1, 64), bool)}
        v = randomize(drawn_init(jax_build(m, None, tc).module.init, rng,
                                 ex, train=False), rng)

        class State:   # what save_checkpoint reads of a TrainState
            step, params, batch_stats, opt_state = 0, v["params"], \
                v["batch_stats"], {}

        save_checkpoint(str(tmp / f"init_{name}"), State)
        ckpts[name] = str(tmp / f"init_{name}" / "latest")
    common = ["--max_points", str(MAX_POINTS)]
    procs = {
        f"dist_test_{name}": port(["-c", _PORT_DIST_TEST_ONE_THREAD,
                                   cfgs[name],
                                   "--device", "cpu", "--checkpoint",
                                   ckpts[name], "--work_dir",
                                   str(tmp / f"port_eval_{name}")] + common)
        for name in PP_CONFIGS}
    train3 = ["--batch_size", "2", "--max_steps_per_epoch", "2"] + common
    procs["train"] = port(["-c", _PORT_TRAIN, cfgs["three-class"],
                           "--device", "cpu", "--work_dir",
                           str(tmp / "port_train"), "--total_steps", "2",
                           "--load_from", ckpts["three-class"]] + train3)
    jax_metrics = {name: _jax_dist_test_one_thread([
        cfgs[name], "--checkpoint", ckpts[name], "--work_dir",
        str(tmp / f"jax_eval_{name}")] + common)[0] for name in PP_CONFIGS}
    run_jax("train", [cfgs["three-class"], "--work_dir",
                      str(tmp / "jax_train"), "--total_steps", "2",
                      "--mesh", "data=1", "--load_from",
                      ckpts["three-class"]] + train3)
    res = {k: finish(p) for k, p in procs.items()}
    later = {
        "resume": port(["-c", _PORT_TRAIN, cfgs["three-class"], "--device",
                        "cpu", "--work_dir", str(tmp / "port_resume"),
                        "--total_steps", "3", "--resume_from",
                        str(tmp / "jax_train" / "latest")] + train3),
        "dist_test_port_ckpt": port([
            "-c", _PORT_DIST_TEST, cfgs["three-class"], "--device", "cpu",
            "--checkpoint", str(tmp / "port_train" / "latest"),
            "--work_dir", str(tmp / "port_eval_own")] + common)}
    res.update({k: finish(p) for k, p in later.items()})
    return dict(tmp=tmp, jax_metrics=jax_metrics, res=res)


def _ok(runs, name):
    res = runs["res"][name]
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [], got["bad"]
    return got


@pytest.mark.parametrize("name", list(PP_CONFIGS))
def test_dist_test_matches_jax_cli(runs, name):
    """``dist_test --device cpu`` from the JAX checkpoint: every frame's
    kept boxes, labels (of the head's 3 or 2 classes) and scores, and the
    Waymo metrics."""
    got = _ok(runs, f"dist_test_{name}")
    jp = load_pred(runs["tmp"] / f"jax_eval_{name}")
    tp = load_pred(runs["tmp"] / f"port_eval_{name}")
    assert sorted(tp) == sorted(jp) == [f"frame{i}" for i in range(4)]
    n_cls = 3 if name == "three-class" else 2
    for token in jp:
        j, t = jp[token], tp[token]
        assert len(t["scores"]) == len(j["scores"]) > 10, token
        np.testing.assert_array_equal(t["label_preds"], j["label_preds"])
        assert set(np.unique(t["label_preds"])) <= set(range(n_cls))
        np.testing.assert_allclose(t["box3d_lidar"], j["box3d_lidar"],
                                   rtol=0, atol=1e-4, err_msg=token)
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=0,
                                   atol=1e-5, err_msg=token)
    jm, tm = runs["jax_metrics"][name], got["metrics"]
    assert sorted(tm) == sorted(jm)
    # the 2-class config's data dict is the 3-class file's, so its
    # evaluation names CYCLIST too (in both packages)
    for cls in ("VEHICLE", "PEDESTRIAN", "CYCLIST"):
        assert np.isfinite(tm[f"AP/L1/{cls}"])
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-6, (k, tm[k], jm[k])


def test_train_cli_steps_match_jax_cli(runs):
    """Two steps of each CLI from the same JAX checkpoint: step 0 within
    1e-4 on the loss terms and 2e-3 on the gradient norm, step 1 (after
    one Adam update at random weights) within 1% and 25%, the bounds of
    ``tests/test_torch_centerpoint.py``."""
    assert _ok(runs, "train")["steps"] == 2

    def read(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    jm, pm = read(runs["tmp"] / "jax_train"), read(runs["tmp"] /
                                                   "port_train")
    assert [r["step"] for r in pm] == [r["step"] for r in jm] == [0, 1]
    for j, p, (tol, norm_tol) in zip(jm, pm, ((1e-4, 2e-3), (0.01, 0.25))):
        assert p["lr"] == pytest.approx(j["lr"], rel=1e-6)
        for k in ("det_loss", "hm_loss", "loc_loss"):
            assert len(p[k]) == 1 and np.isfinite(p[k][0]), (k, p[k])
            assert abs(p[k][0] - j[k]) <= tol * abs(j[k]), (j["step"], k)
        assert abs(p["loss"] - j["loss"]) <= tol * abs(j["loss"])
        assert abs(p["grad_norm"] - j["grad_norm"]) <= norm_tol * j[
            "grad_norm"]


def test_train_cli_resumes_from_a_jax_state(runs):
    """``train --resume_from`` the JAX run's ``state.pkl`` (weights,
    statistics, the Adam count and moments) loads strictly and takes the
    third step: one record, at step 2, finite."""
    assert _ok(runs, "resume")["steps"] == 3
    with open(runs["tmp"] / "port_resume" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2]
    assert np.isfinite(recs[0]["loss"]) and recs[0]["grad_norm"] > 0
    assert "ckpt_00000003" in os.listdir(runs["tmp"] / "port_resume")


def test_dist_test_loads_a_port_checkpoint(runs):
    """``dist_test --checkpoint`` the port train run's own checkpoint
    (step 2) loads strictly and writes every frame's detections."""
    got = _ok(runs, "dist_test_port_ckpt")
    assert got["fps"] > 0 and np.isfinite(got["metrics"]["mAP/L1"])
    tp = load_pred(runs["tmp"] / "port_eval_own")
    assert sorted(tp) == [f"frame{i}" for i in range(4)]
    assert all(len(t["scores"]) > 10 for t in tp.values())


# ------------------------------------------------------- build and refusals

@pytest.mark.parametrize("name", list(PP_CONFIGS))
def test_full_width_builds_with_jax_parameter_count(name):
    """Each config at its full width and grid on the meta device: 468 x
    468 pillars, the PFN 10 -> 64 and 128 -> 64, the RPN's 384 channels,
    one task of 3 (2) classes at stride 1; the parameter count equal to
    ``jax.eval_shape`` of the JAX detector's init, leaf by leaf."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, PP_CONFIGS[name]))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    mod = det.module
    assert det.input_kind == "points" and det.voxel_shape == "cuboid"
    assert mod.grid_size == (468, 468, 1) and mod.max_pillars == 32768
    assert tuple(mod.reader.pfn0_dense.weight.shape) == (64, 10)
    assert tuple(mod.reader.pfn1_dense.weight.shape) == (64, 128)
    assert mod.bbox_head.Conv_0.weight.shape[1] == 384
    n_cls = 3 if name == "three-class" else 2
    assert mod.bbox_head.task0.hm_out.weight.shape[0] == n_cls
    ex = {"points": np.zeros((1, 64, 7), np.float32),
          "points_mask": np.zeros((1, 64), bool)}
    shapes = jax.eval_shape(
        lambda: jax_build(cfg["model"], cfg["train_cfg"],
                          cfg["test_cfg"]).module.init(
            jax.random.PRNGKey(0), ex, train=False))
    want = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
    sd = mod.state_dict()
    assert sorted(want) == sorted(sd)
    for k, t in sd.items():
        assert tuple(want[k].shape) == tuple(t.shape), k
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in mod.parameters()) == n_jax


def test_what_is_not_ported_raises():
    """A seg head, once a raise naming its ROADMAP item, builds HAN's
    ``SingleConvHead`` over the canvas and the RPN's map (held against JAX
    in ``tests/test_torch_strobe.py``); the E2E head's block route raises;
    a PFN reader or a pillar scatter under VoxelNet names the PointPillars
    detector. The two-stage detector over this first stage, once such a
    raise, now builds (held against JAX in
    ``tests/test_torch_pp_two_stage.py``)."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    m, tc = tiny_pp_cfg()
    det = build_detector(dict(m, seg_head=dict(type="SingleConvHead",
                                               weight=2)), None, tc,
                         device="meta")
    assert type(det.module.seg_head).__name__ == "SingleConvHead"
    assert det.module.seg_head.Conv_0.weight.shape[1] == 16 + 48
    assert det.seg_weight == 2 and "points_label" in det.loss_keys
    with pytest.raises(ValueError, match="use_block_kernel"):
        build_detector(m, None, tc, device="meta", use_block_kernel=True)
    two = load_config(os.path.join(
        ROOT, "configs/waymo/pp/two_stage/"
        "waymo_centerpoint_pp_two_pfn_stride1_two_stage_bev_6epoch.py"))
    det = build_detector(two["model"], two["train_cfg"], two["test_cfg"],
                         device="meta")
    assert type(det.module.first).__name__ == "PointPillarsModule"
    assert det.freeze and det.first_driver.voxel_shape == "cuboid"
    cp = load_config(os.path.join(
        ROOT, "configs/waymo/waymo_centerpoint_voxelnet_36epoch.py"))
    for change in (dict(backbone=dict(type="PointPillarsScatter")),
                   dict(reader=dict(type="PillarFeatureNet"))):
        with pytest.raises(NotImplementedError, match="PointPillars"):
            build_detector(dict(cp["model"], **change), device="meta")
