"""partner_tpu_torch's data parallelism on two gloo ranks of the CPU.

The invariant: a step over N ranks, each holding its part of a global
batch of 4, computes what one process computes on the whole batch (JAX's
``data`` mesh axis does, ``tests/test_dp_parity.py``): the same logged
loss terms, gradients, parameters and BatchNorm statistics. One launch of
two ranks (``tests/torch_dist_cases.py``) runs every case below; the test
process runs each detector's one-process step and the JAX references.

Bounds are those the one-process parity tests use for each family
(``tests/test_torch_train.py``, ``test_torch_nusc_train.py``): loss terms
at 1e-5 relative; gradients per tensor within ``GRAD_RMS`` relative RMS
(the train-mode network upstream of the heads is chaotic at random
weights: two summation orders move its gradients ~2e-3 here), or within
rounding noise of a true gradient of 0 (a bias before a batch-statistics
BatchNorm); BatchNorm statistics at 1e-5; parameters within 2 lr of each
other and at 2e-6 wherever Adam's first step is determined. PARTNER's
rule for "determined" (``test_torch_train.py``): the clipped gradients
agree in sign and stand clear of Adam's eps, at most 1% of the elements
not; the others' (``test_torch_nusc_train.py``; a 3D trunk or a pillar
encoder upstream moves more elements near eps): the clipped gradients
agree within 1% and stand clear of ``ADAM_CLEAR``, at least half of the
elements so.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as tdc
from torch_port_fixtures import (CENTERPOINT, PP_TWO_STAGE,
                                 POLARSTREAM_SEG_CONFIGS, TINY_GRID,
                                 drawn_init, load_converted, nusc_batch,
                                 randomize, tiny_centerpoint_cfg,
                                 tiny_frame_cfg, tiny_polarstream_cfg,
                                 tiny_pp_two_stage_cfg, write_tiny_nusc_set)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_RMS = 1e-2
ADAM_CLEAR = 1e-7
LR_MAX = 3e-3
FAMILIES = ("partner", "centerpoint", "pp_two_stage", "polarstream_seg")


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _randomized(det, seed):
    """Every norm parameter and statistic drawn (a fresh LayerNorm leaves
    the SetBlock's keypoint saliency at rounding noise)."""
    cs = _chip_smoke()
    with torch.no_grad():
        cs.randomize_norms(det.module, torch.Generator().manual_seed(seed))
        cs.randomize_masked_norms(det.module,
                                  torch.Generator().manual_seed(seed + 1))
    return {k: v.clone() for k, v in det.module.state_dict().items()}


def _partner_task():
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_frame_cfg()
    m["neck"] = dict(m["neck"], set_drop=0.0, set_attn_drop=0.0,
                     set_drop_path=0.0)
    pr = m["bbox_head"]["voxel_generator"]["range"]
    ex = _chip_smoke().train_example(np.random.RandomState(1), pr, TINY_GRID,
                                     4, 1200, 1500, 8)
    det = build_detector(m, None, tc, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return dict(kind="step", name="partner", model=m, test_cfg=tc,
                state_dict=_randomized(det, 1), example=ex)


def _centerpoint_task():
    """Drawn JAX weights (the JAX step runs on them too), and no box in
    the second rank's samples: its local counts are 0."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    m, tc = tiny_centerpoint_cfg()
    train_cfg = load_config(os.path.join(ROOT, CENTERPOINT))["train_cfg"]
    ex = _chip_smoke().centerpoint_train_example(
        np.random.RandomState(2), m, train_cfg, 4, 1500, 1800, 12)
    for k in ("hm", "mask"):
        for a in ex[k]:
            a[2:] = 0
    ex = {k: ex[k] for k in ("points", "points_mask", "hm", "anno_box",
                             "ind", "mask", "cat")}
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(7)
    v = randomize(drawn_init(jdet.init, rng, {
        "points": ex["points"][:, :64],
        "points_mask": ex["points_mask"][:, :64]}), rng)
    det = build_detector(m, None, tc, device="cpu")
    load_converted(det.module, v)
    return dict(kind="step", name="centerpoint", model=m, test_cfg=tc,
                state_dict={k: t.clone() for k, t in
                            det.module.state_dict().items()},
                example=ex), (jdet, v)


def _pp_two_stage_task():
    """The PointPillars two-stage pair trained whole (``freeze`` off, so
    the pillar encoder's MaskedBatchNorm trains): gt boxes planted on the
    first rank's samples at the train-mode first stage's proposals, none
    on the second's."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cs = _chip_smoke()
    m, tc = tiny_pp_two_stage_cfg()
    m["freeze"] = False
    train_cfg = load_config(os.path.join(ROOT, PP_TWO_STAGE))["train_cfg"]
    ex = cs.pp_train_example(np.random.RandomState(3), m["first_stage_cfg"],
                             train_cfg, 4, 3000, 3500, 12)
    det = build_detector(m, None, tc, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    sd = _randomized(det, 3)
    ex["global_box"] = np.zeros((4, 12, 10), np.float32)
    det.module.train()
    ex = cs.plant_positives(det, ex, "cpu")
    ex["global_box"][2:] = 0
    ex["global_box_mask"][2:] = False
    return dict(kind="step", name="pp_two_stage", model=m, test_cfg=tc,
                state_dict=sd, example={k: ex[k] for k in det.loss_keys})


def _polarstream_seg_task(root):
    from partner_tpu_torch.models import build_detector

    info = write_tiny_nusc_set(root, seed=15, lidarseg=True)
    config = POLARSTREAM_SEG_CONFIGS["1_sector"]
    m, tc = tiny_polarstream_cfg(config)
    batch = nusc_batch(config, m, info, root, "train", 4, seed=4)
    det = build_detector(m, None, tc, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return dict(kind="step", name="polarstream_seg", model=m, test_cfg=tc,
                state_dict=_randomized(det, 5),
                example={k: batch[k] for k in det.loss_keys})


def _norms_task(rng):
    """A BatchNorm over (4, 5, 7, 6) and a MaskedBatchNorm over (4, 9, 6)
    rows whose second rank holds no valid row."""
    c = 6
    state = lambda: {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, c)
                                                .astype(np.float32)),
                     "bias": torch.from_numpy(rng.normal(0, 0.2, c)
                                              .astype(np.float32)),
                     "running_mean": torch.from_numpy(rng.normal(
                         0, 0.2, c).astype(np.float32)),
                     "running_var": torch.from_numpy(rng.uniform(
                         0.5, 1.5, c).astype(np.float32))}
    bn = state()
    masked = dict(zip(("scale", "bias", "mean", "var"), state().values()))
    mask = rng.rand(4, 9) < 0.6
    mask[2:] = False
    return dict(kind="norms", name="norms", c=c, bn_state=bn,
                masked_state=masked, mask=mask,
                bn_x=(4.0 + rng.randn(4, 5, 7, c)).astype(np.float32),
                bn_cot=rng.randn(4, 5, 7, c).astype(np.float32),
                masked_x=(2.0 + rng.randn(4, 9, c)).astype(np.float32),
                masked_cot=rng.randn(4, 9, c).astype(np.float32))


def _gather_task(rng):
    return dict(kind="gather", name="gather", sizes=[3, 2000],
                x=rng.randn(2, 3, 4).astype(np.float32),
                w_cat=rng.randn(6, 4).astype(np.float32),
                w_sum=rng.randn(2, 3, 4).astype(np.float32),
                flags=rng.rand(2, 5) < 0.5)


def _unused_task():
    return dict(kind="unused", name="unused", steps=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two ranks in one launch, and each family's one-process
    step -> (two-rank results, one-process results, tasks by name, the
    CenterPoint case's JAX detector and variables)."""
    root = str(tmp_path_factory.mktemp("dist"))
    rng = np.random.RandomState(0)
    cp, jax_cp = _centerpoint_task()
    tasks = [_partner_task(), cp, _pp_two_stage_task(),
             _polarstream_seg_task(os.path.join(root, "nusc")),
             _norms_task(rng), _gather_task(rng), _unused_task()]
    handle = tdc.start(tasks, os.path.join(root, "out"))
    by_name = {t["name"]: t for t in tasks}
    one = {n: tdc.run_step(by_name[n], 0, 1) for n in FAMILIES}
    one["unused"] = tdc.run_unused(by_name["unused"], 0, 1)
    jax_cp = jax_cp + (_jax_centerpoint_step(*jax_cp,
                                             by_name["centerpoint"]),)
    return tdc.collect(handle), one, by_name, jax_cp


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).sum()
                         / max((want ** 2).sum(), 1e-300)))


def _flat(metrics):
    return {k: np.asarray(v, np.float64) for k, v in metrics.items()}


def hold_step(got, want, rule="agree", lr_max=LR_MAX, loss_rtol=LOSS_RTOL):
    """One step's results (``torch_dist_cases.step_result``) against a
    reference's, by the bounds of the module docstring; ``rule`` "sign"
    (PARTNER's) or "agree" decides where Adam's first step is
    determined."""
    g, w = _flat(got["metrics"]), _flat(want["metrics"])
    assert sorted(g) == sorted(w)
    for k in w:
        if k == "num_matched":
            assert g[k] == w[k]
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=loss_rtol,
                                       err_msg=k)
    assert sorted(got["grads"]) == sorted(want["grads"])
    gmax = max(float(t.abs().max()) for t in want["grads"].values())
    for name, r in want["grads"].items():
        a, b = got["grads"][name].numpy(), r.numpy()
        assert (rel_rms(a, b) <= GRAD_RMS
                or np.abs(a - b).max() <= 1e-5 * gmax), (name, rel_rms(a, b))
    lr0 = lr_max / 10.0
    # the clipped gradient is the one Adam's first step reads
    scale = min(1.0, 35.0 / float(w["grad_norm"]))
    n_firm = n_all = 0
    for k, r in want["state"].items():
        a, b = got["state"][k].numpy(), r.numpy()
        if k not in want["grads"]:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)
            continue
        assert np.all(np.abs(a - b) <= 2 * lr0 * 1.01 + 1e-6), k
        ga = got["grads"][k].numpy() * scale
        gb = want["grads"][k].numpy() * scale
        if rule == "sign":
            firm = (np.sign(ga) == np.sign(gb)) & (np.abs(gb) > 1e-6)
        else:
            firm = (np.abs(gb) > ADAM_CLEAR) & (np.abs(ga - gb)
                                                <= 1e-2 * np.abs(gb))
        np.testing.assert_allclose(a[firm], b[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_firm += int(firm.sum())
        n_all += firm.size
    assert n_firm >= (0.99 if rule == "sign" else 0.5) * n_all, (n_firm,
                                                                 n_all)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_ranks_step_as_one_process(runs, family):
    """Each family's step over two ranks (a global batch of 4, 2 a rank)
    against one process's step on the whole batch: the logged terms are
    the global batch's, the gradients the whole batch's (so the clip, at
    gradient norms of 27-1,100 against 35, clips alike), and the two ranks
    end bit-equal. PARTNER: the set losses over the auction matcher, the
    same matches; CenterPoint: the focal and regression normalizers with no
    box on the second rank; PointPillars two-stage: the pillar encoder's
    masked BatchNorm and the RoI losses, positives on the first rank only;
    PolarStream det + seg: the cross entropy and the Lovasz-softmax over
    both ranks' cells."""
    two, one, _, _ = runs
    r0, r1 = two[family]
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert r0["metrics"] == r1["metrics"]
    hold_step(r0, one[family], "sign" if family == "partner" else "agree")
    if family == "pp_two_stage":
        assert one[family]["metrics"]["roi_reg_loss"] > 0
    if family == "partner":
        assert one[family]["metrics"]["num_matched"] > 0
    assert r0["collectives"] > 0


def _jax_centerpoint_step(jdet, v, task):
    """``jax.jit(make_train_step)`` on the CenterPoint case's whole batch
    -> (the state after, the metrics)."""
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step

    tx = jax_opt(lr_max=LR_MAX, total_steps=1000)
    jex = jax.tree_util.tree_map(jnp.asarray, task["example"])
    return jax.jit(lambda s: jax_step(jdet, tx)(
        s, jex, jax.random.PRNGKey(1)))(create_train_state(v, tx))


def test_centerpoint_two_ranks_match_jax(runs):
    """The CenterPoint case's two-rank step against
    ``jax.jit(make_train_step)`` on the whole global batch from the same
    weights: loss terms, gradients (the JAX step's, read back from Adam's
    first moment), statistics and parameters after the step."""
    from partner_tpu_torch.convert import flax_to_torch

    two, _, _, (_, _, (new_state, jmet)) = runs
    b1 = np.float32(0.95)
    grads = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) / (np.float32(1) - b1),
        new_state.opt_state.inner_state[1].mu)})
    got = two["centerpoint"][0]
    scale = min(1.0, 35.0 / got["metrics"]["grad_norm"])
    want = {"metrics": {k: ([float(x) for x in val] if isinstance(val, list)
                            else float(val)) for k, val in jmet.items()},
            "grads": {k: t / scale for k, t in grads.items()},
            "state": flax_to_torch(jax.tree_util.tree_map(np.asarray, {
                "params": new_state.params,
                "batch_stats": new_state.batch_stats}))}
    hold_step(got, want)


def test_norms_take_the_global_batch_statistics(runs):
    """BatchNorm and MaskedBatchNorm in train mode inside a data-parallel
    step, on two ranks (the second holding no valid row of the masked
    one), against flax's modules on the whole batch: outputs, the input
    and parameter gradients of ``sum(out * cot)``, the running statistics
    after."""
    import flax.linen as fnn

    from partner_tpu.models.layers import MaskedBatchNorm as JMasked

    two, _, tasks, _ = runs
    t = tasks["norms"]
    r = two["norms"]
    for key in ("bn", "masked"):
        st = {k: v.numpy() for k, v in t[key + "_state"].items()}
        if key == "bn":
            jm = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                               epsilon=1e-3)
            v = {"params": {"scale": st["weight"], "bias": st["bias"]},
                 "batch_stats": {"mean": st["running_mean"],
                                 "var": st["running_var"]}}
            call = lambda vv, x: jm.apply(vv, x, mutable=["batch_stats"])
        else:
            jm = JMasked()
            v = {"params": {"scale": st["scale"], "bias": st["bias"]},
                 "batch_stats": {"mean": st["mean"], "var": st["var"]}}
            call = lambda vv, x: jm.apply(vv, x, jnp.asarray(t["mask"]),
                                          mutable=["batch_stats"])
        cot = t[key + "_cot"]

        def f(params, x):
            y, upd = call({"params": params,
                           "batch_stats": v["batch_stats"]}, x)
            return jnp.sum(y * cot), (y, upd["batch_stats"])

        (gp, gx), (ref, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
            v["params"], jnp.asarray(t[key + "_x"]))
        got_y = torch.cat([r[i][key]["y"] for i in range(2)]).numpy()
        got_gx = torch.cat([r[i][key]["x_grad"] for i in range(2)]).numpy()
        np.testing.assert_allclose(got_y, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        gtol = dict(rtol=1e-4, atol=1e-4 * float(np.abs(gx).max()))
        np.testing.assert_allclose(got_gx, np.asarray(gx), err_msg=key,
                                   **gtol)
        names = (("weight", "scale"), ("bias", "bias")) if key == "bn" \
            else (("scale", "scale"), ("bias", "bias"))
        for tn, jn in names:   # each rank's part of the parameter gradient
            got = sum(r[i][key]["param_grads"][tn] for i in range(2))
            np.testing.assert_allclose(got.numpy(), np.asarray(gp[jn]),
                                       err_msg=tn, **gtol)
        stat_names = (("running_mean", "mean"), ("running_var", "var")) \
            if key == "bn" else (("mean", "mean"), ("var", "var"))
        for tn, jn in stat_names:
            for i in range(2):
                np.testing.assert_allclose(
                    r[i][key]["state"][tn].numpy(), np.asarray(stats[jn]),
                    rtol=1e-5, atol=1e-5, err_msg=(key, tn, i))


def test_gather_and_the_collectives_gradients(runs):
    """``all_gather_object`` gives every rank the payloads in rank order,
    of unequal size; ``global_cat`` concatenates in rank order and hands
    each rank the sum of both ranks' cotangents of its rows (gloo has no
    ``reduce_scatter``: the port all-reduces the whole cotangent);
    ``global_sum``'s cotangent is summed over the ranks too; a bool tensor
    gathers as bool."""
    two, _, tasks, _ = runs
    t = tasks["gather"]
    x = t["x"]
    for rank in range(2):
        r = two["gather"][rank]
        assert [o["rank"] for o in r["objs"]] == [0, 1]
        for o, n in zip(r["objs"], t["sizes"]):
            np.testing.assert_array_equal(o["blob"], np.arange(n))
        np.testing.assert_array_equal(r["cat"].numpy(),
                                      np.concatenate(list(x)))
        np.testing.assert_allclose(r["sum"].numpy(), x.sum(0), rtol=1e-6)
        # d/dx_r of sum over ranks of (cat . w_cat + sum . w_sum[rank])
        want = (2 * t["w_cat"][rank * 3:(rank + 1) * 3]
                + t["w_sum"].sum(0))
        np.testing.assert_allclose(r["x_grad"].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        assert r["flags"].dtype == torch.bool
        np.testing.assert_array_equal(r["flags"].numpy(),
                                      np.concatenate(list(t["flags"])))


def test_parameters_a_loss_leaves_unused(runs):
    """A module whose loss reads one of its two layers: two data-parallel
    steps run (DDP would stop at the second without finding the unused
    layer), the used layer's gradients are the whole batch's, the unused
    layer gets none and keeps its weights, as one process's steps."""
    two, one, _, _ = runs
    for rank in range(2):
        got = two["unused"][rank]
        for step_got, step_want in zip(got, one["unused"]):
            assert sorted(step_got["grads"]) == sorted(step_want["grads"]) \
                == ["used.bias", "used.weight"]
            for k, w in step_want["grads"].items():
                np.testing.assert_allclose(step_got["grads"][k].numpy(),
                                           w.numpy(), rtol=1e-6, atol=1e-7)
            for k, w in step_want["state"].items():
                np.testing.assert_allclose(step_got["state"][k].numpy(),
                                           w.numpy(), rtol=1e-6, atol=1e-7)


def test_initialize_sets_the_device_before_nccl(monkeypatch):
    """``initialize`` is a no-op without torchrun's variables; with them
    it picks NCCL for a CUDA device after ``torch.cuda.set_device(
    LOCAL_RANK)`` (a communicator made first would bind the wrong card),
    gloo for the CPU, and the address torchrun gives."""
    import torch.distributed as tdist

    from partner_tpu_torch.parallel import dist

    calls = []
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize("cuda") is False and calls == []
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29123")
    try:
        assert dist.initialize("cuda") is True
        assert calls == [("set_device", 1), ("nccl", dict(
            init_method="tcp://localhost:29123", rank=3, world_size=4))]
        calls.clear()
        assert dist.initialize("cpu") is True
        assert calls == [("gloo", dict(init_method="tcp://localhost:29123",
                                       rank=3, world_size=4))]
    finally:
        dist._state["owned"] = False


def test_collectives_outside_a_step_are_the_identity():
    """Without a process group, or outside ``reducing``, the collectives
    return their input, so the norms and losses, which always take their
    sums through them, compute the statistics of this process's batch."""
    from partner_tpu_torch.parallel import dist

    t = torch.arange(6.0).reshape(3, 2)
    assert dist.process_info() == (0, 1) and dist.is_main_process()
    assert dist.world_size() == 1
    assert dist.global_sum(t) is t and dist.global_cat(t) is t
    assert dist.all_gather_object({"a": 1}) == [{"a": 1}]


def test_mesh_spec_as_jax_and_the_data_axis(capsys):
    """``parse_mesh_spec`` gives what the JAX package's gives; the CLIs'
    check takes a mesh of the world (data-only or not) and stops on the
    rest, naming the cause: a mesh that is not the world's, and the
    azimuth axis on a detector other than VoxelNetV3 and VoxelNet."""
    from partner_tpu.parallel.mesh import parse_mesh_spec as jparse
    from partner_tpu_torch.parallel.mesh import check, parse_mesh_spec
    from torch_port_fixtures import tiny_pp_cfg

    for spec in (None, "", "auto", "data=2", "model=2", "data=2,model=2",
                 "azimuth=2", "data=1,model=2,azimuth=2"):
        assert parse_mesh_spec(spec, 8) == jparse(spec, 8), spec
    with pytest.raises(ValueError, match="unknown mesh axis"):
        parse_mesh_spec("batch=2", 8)
    flagship, pp = tiny_frame_cfg()[0], tiny_pp_cfg()[0]
    assert check(None, 2, "train") == (2, 1, 1)
    assert check("data=2", 2, "t") == (2, 1, 1)
    assert check("data=2,model=2", 4, "t", 2, flagship) == (2, 2, 1)
    assert check("azimuth=2", 2, "t", 2, flagship) == (1, 1, 2)
    for spec, model, msg in (("data=2", flagship, "asks for data=2"),
                             ("data=2,model=2", flagship, "but 1 run"),
                             ("data=1,azimuth=2", pp,
                              "PointPillars takes no bev_pspec"),
                             ("batch=2", flagship, "unknown mesh axis")):
        with pytest.raises(SystemExit, match=msg):
            check(spec, 1 if model is flagship else 2, "train", 2, model)


def test_loader_splits_each_global_batch_by_position(tmp_path):
    """Rank r of N loads the r-th B / N samples of each global batch that
    one process loads, whole samples: a group sampler's batch stays in one
    group, and a double-flip sample's four point rows stay together on
    one rank (the nuScenes flip config's val items)."""
    from partner_tpu_torch.data import build_dataloader, build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.utils.config import load_config
    from torch_port_fixtures import NUSC_FLIP

    class Items:
        flag = np.array([0, 1, 0, 1, 0, 1, 0, 1, 1, 1])

        def __len__(self):
            return len(self.flag)

        def __getitem__(self, i):
            return int(i)

    ident = lambda items: items
    for shuffle in (True, False):
        one = list(DataLoader(Items(), 4, shuffle=shuffle, num_workers=1,
                              collate_fn=ident))
        parts = [list(DataLoader(Items(), 4, shuffle=shuffle, num_workers=1,
                                 collate_fn=ident, rank=r, world_size=2))
                 for r in range(2)]
        assert [a + b for a, b in zip(*parts)] == one
        if shuffle:
            assert all(len(set(Items.flag[b])) == 1 for b in one)
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(Items(), 3, rank=0, world_size=2)

    root = str(tmp_path)
    info = write_tiny_nusc_set(root, seed=3)
    # one sweep: no sweep drawn from a rank's own random state
    ds_cfg = dict(load_config(os.path.join(ROOT, NUSC_FLIP))["data"]["val"],
                  info_path=info, root_path=root, nsweeps=1)
    load = lambda r, n: list(build_dataloader(
        build_dataset(dict(ds_cfg)), 2, workers_per_gpu=1, shuffle=False,
        max_points=6000, rank=r, world_size=n))
    one = load(0, 1)
    parts = [load(r, 2) for r in range(2)]
    assert len(one) == 2 and one[0]["points"].shape[0] == 8
    for b, (p0, p1) in enumerate(zip(*parts)):
        assert p0["points"].shape[0] == p1["points"].shape[0] == 4
        for k in ("points", "points_mask"):
            np.testing.assert_array_equal(
                np.concatenate([p0[k], p1[k]]), one[b][k], err_msg=k)
        assert [m["token"] for m in p0["metadata"] + p1["metadata"]] == [
            m["token"] for m in one[b]["metadata"]]
