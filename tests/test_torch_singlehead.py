"""The nuScenes single-head cylinder CenterPoint in partner_tpu_torch
against the JAX package (CPU, float32).

``configs/nusc/voxelnet/voxelnet_det_cylinder_singlehead.py``:
``VoxelNet`` with ``CenterHeadSinglePos`` (one task of 10 classes, the
merged ``rot_vel`` head, rectified decode and targets) and the per-class
NMS. Its modules from one converted, randomized parameter tree:
``RSNorm`` with a ragged range tail, ``RangeStratified``, ``ConvGNStack``
with groups and flax's ``GroupNorm``, both single heads in eval and train
mode, and the flax init; ``batched_rotated_nms`` and the per-class
post-process (kept indices exact, ties included); the config cut to the
tiny grid (``torch_port_fixtures.tiny_centerpoint_cfg``): ``predict`` of
one shared JAX detector, one train step on a batch of the port's data
path; the CLIs at that size; the full width on the meta device.
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

from test_torch_centerpoint import finish, port
from test_torch_nusc_train import ADAM_CLEAR, GRAD_RMS, OUT_RMS, four_ulp
from torch_port_fixtures import (SINGLEHEAD, jax_apply, jax_init,
                                 load_converted, nusc_batch,
                                 nusc_jax_variables, randomize,
                                 synthetic_points, tiny_centerpoint_cfg,
                                 write_tiny_nusc_config, write_tiny_nusc_set)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides, another summation order: each module and head
# output below measured within 2e-6, the tiny frame's head maps (behind
# the backbone and RPN) within 9e-6 absolute
MAP_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def single_head_cfg(head_type="CenterHeadSinglePos", in_channels=32):
    """The config's bbox_head as ``build_voxelnet`` hands it to the head in
    both packages (tasks as tuples, common_heads sorted, the detector's
    keys taken out, ``voxel_generator`` kept for the position encoding),
    at ``in_channels``."""
    from partner_tpu_torch.utils.config import load_config

    bh = copy.deepcopy(load_config(os.path.join(ROOT, SINGLEHEAD))["model"][
        "bbox_head"])
    for k in ("voxel_shape", "code_weights", "weight", "dataset"):
        bh.pop(k)
    bh["tasks"] = tuple({"class_names": tuple(tk["class_names"])}
                        for tk in bh["tasks"])
    bh["common_heads"] = tuple(sorted((k, tuple(v)) for k, v in
                                      bh["common_heads"].items()))
    return dict(bh, type=head_type, in_channels=in_channels)


def _flax(module, x, rng):
    """(randomized flax variables, the flax output as numpy)."""
    v = randomize(jax_init(module, x), rng)
    return v, jax_apply(module, v, x)


def _load_as(name, module, v):
    """``module`` loaded strictly from flax variables ``v`` converted as
    the head's submodule ``name`` (the converter keeps the raw layouts of
    ``shared_norm`` and ``*_rs`` by that name)."""
    load_converted(torch.nn.ModuleDict({name: module}),
                   {col: {name: tree} for col, tree in v.items()})
    return module.eval()


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("w, heads", [(19, 1), (16, 2), (4, 1)],
                         ids=["ragged", "two-heads", "one-cell-strata"])
def test_rsnorm_matches_jax(rng, w, heads):
    """Range strata of w // 4 cells, a ragged tail of w % 4 cells on the
    last stratum's statistics and affine, channel groups per head."""
    from partner_tpu.models.center_head import RSNorm as JaxRSNorm
    from partner_tpu_torch.models.center_head import RSNorm

    x = (rng.randn(2, 6, w, 8) * 2 + 1).astype(np.float32)
    v, want = _flax(JaxRSNorm(heads, 4), x, rng)
    m = _load_as("shared_norm", RSNorm(heads, 4, 8), v)
    assert tuple(m.scale.shape) == (4, 1, 8)
    with torch.no_grad():
        got = m(t(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=MAP_TOL, atol=MAP_TOL)


@pytest.mark.parametrize("w", [16, 19], ids=["exact", "ragged"])
def test_range_stratified_matches_jax(rng, w):
    """The per-stratum conv with its one-cell range halo, GroupNorm per
    stratum and ReLU: 8 strata of 2 cells, the output 16 cells wide at
    either width, as JAX's."""
    from partner_tpu.models.center_head import \
        RangeStratified as JaxRangeStratified
    from partner_tpu_torch.models.center_head import RangeStratified

    x = rng.randn(2, 5, w, 6).astype(np.float32)
    v, want = _flax(JaxRangeStratified(12, 8), x, rng)
    assert v["params"]["kernel"].shape == (8, 3, 3, 6, 12)
    m = _load_as("reg_rs", RangeStratified(6, 12, 8), v)
    with torch.no_grad():
        got = m(t(x)).numpy()
    assert got.shape == want.shape == (2, 5, 16, 12)
    np.testing.assert_allclose(got, want, rtol=MAP_TOL, atol=MAP_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_conv_gn_stack_matches_jax(rng, groups):
    """A grouped 3x3 conv, flax's ``GroupNorm`` (64 groups of one channel,
    eps 1e-6, the fast variance), ReLU and the grouped output conv with
    its ``init_bias``; the output groups in flax's order."""
    from partner_tpu.models.center_head import ConvGNStack as JaxStack
    from partner_tpu_torch.models.center_head import ConvGNStack

    x = rng.randn(2, 7, 9, 16).astype(np.float32)
    v, want = _flax(JaxStack(2 * groups, 2, groups=groups, init_bias=-2.19),
                    x, rng)
    assert v["params"]["Conv_0"]["kernel"].shape == (3, 3, 16 // groups, 64)
    m = load_converted(ConvGNStack(16, 2 * groups, 2, groups=groups,
                                   init_bias=-2.19), v)
    assert tuple(m.Conv_0.weight.shape) == (64, 16 // groups, 3, 3)
    with torch.no_grad():
        got = m(t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=MAP_TOL, atol=MAP_TOL)


def test_group_norm_is_flax_group_norm(rng):
    """flax's ``GroupNorm`` has eps 1e-6 where torch's has 1e-5: on
    channels of variance ~1e-6 the port's norm stays within 1e-5 of
    flax's (measured 2e-7), torch's ``nn.GroupNorm`` lies 30% away."""
    import flax.linen as fnn

    from partner_tpu_torch.models.center_head import GroupNorm

    x = (rng.randn(2, 6, 5, 8) * 1e-3).astype(np.float32)
    v, want = _flax(fnn.GroupNorm(num_groups=8), x, rng)
    m = load_converted(GroupNorm(8, 8), v)
    with torch.no_grad():
        got = m(t(x)).numpy()
        tg = torch.nn.GroupNorm(8, 8)
        tg.weight.copy_(m.weight)
        tg.bias.copy_(m.bias)
        theirs = tg(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=MAP_TOL, atol=MAP_TOL)
    assert np.abs(theirs - want).max() > 0.3 * np.abs(want).max()


@pytest.fixture(scope="module", params=["CenterHeadSingle",
                                        "CenterHeadSinglePos"])
def heads(request):
    """One head type in both packages from one randomized flax tree, at a
    16 x 19 map (a ragged range for both stratifications)."""
    from partner_tpu.models import registry as jreg
    from partner_tpu_torch.models import registry as treg

    rng = np.random.RandomState(5)
    hc = single_head_cfg(request.param)
    x = rng.randn(2, 16, 19, 32).astype(np.float32)
    jhead = jreg.build_from_cfg(dict(hc), jreg.BBOX_HEADS)
    flax_v = jax_init(jhead, x, train=False)
    v = randomize(flax_v, rng)
    thead = load_converted(treg.build_from_cfg(dict(hc), treg.BBOX_HEADS), v)
    return dict(name=request.param, hc=hc, x=x, jhead=jhead, v=v,
                flax_v=flax_v, thead=thead)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_single_head_maps_match_jax(heads, train):
    """Every map of both head types in both modes (no statistics or
    dropout: the modes compute the same function), in sorted name order,
    ``rot`` and ``vel`` the halves of ``rot_vel``; ``reg`` 16 cells wide
    (8 strata of 2), the other maps 19."""
    want = jax_apply(heads["jhead"], heads["v"], heads["x"],
                     train=train)["det_preds"]
    th = heads["thead"].train(train)
    with torch.no_grad():
        got = th(t(heads["x"]))["det_preds"]
    th.eval()
    assert len(got) == len(want) == 1
    got, want = got[0], want[0]
    assert list(got) == sorted(want) == ["dim", "height", "hm", "reg", "rot",
                                         "vel"]
    assert got["hm"].shape == (2, 16, 19, 10)
    assert got["reg"].shape == (2, 16, 16, 2)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=MAP_TOL,
                                   atol=MAP_TOL * np.abs(want[k]).max(),
                                   err_msg=k)


def test_single_head_init_is_flax_init(heads):
    """A fresh port head starts where a fresh flax head does, leaf by
    leaf: the same names and shapes; every kernel at flax's spread (the
    ``RangeStratified`` kernel's fan in counts its 8 strata: 8 x 9 x 64);
    scales one, biases zero but ``hm_stack``'s output at ``init_bias``."""
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import registry as treg
    from partner_tpu_torch.models.layers import init_weights

    head = treg.build_from_cfg(dict(heads["hc"]), treg.BBOX_HEADS)
    init_weights(head, torch.Generator().manual_seed(0))
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                dict(heads["flax_v"])))
    got = head.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        assert g.shape == w.shape, k
        if w.std() > 0:
            assert abs(g.std() / w.std() - 1) < 0.15, (k, g.std(), w.std())
            assert abs(g.mean()) < 0.2 * g.std(), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    rs = got["reg_rs.kernel"].numpy()
    assert rs.shape == (8, 3, 3, 64, 64)
    assert abs(rs.std() * (8 * 9 * 64) ** 0.5 - 1) < 0.05
    assert np.all(got["hm_stack.Conv_1.bias"].numpy() == np.float32(-2.19))


# --------------------------------------------------------- per-class NMS

def _clustered(rng, n, k=12, spread=30.0):
    """(n, 5) BEV boxes around k centres: the NMS suppresses."""
    c = rng.uniform(-spread, spread, (k, 2))[rng.randint(0, k, n)]
    return np.concatenate([c + rng.randn(n, 2) * 0.3,
                           rng.uniform(1, 4, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def test_batched_rotated_nms_matches_jax(rng, monkeypatch):
    """Four classes, score ties, padding rows far out: the kept indices
    and mask equal JAX's, and the shifted boxes bit-equal to JAX's
    expression (the extent over every row, the padding's too)."""
    import partner_tpu_torch.ops.nms as tnms
    from partner_tpu.ops.nms import batched_rotated_nms as jfn

    n = 400
    boxes = _clustered(rng, n)
    labels = rng.randint(0, 4, n).astype(np.int32)
    scores = rng.rand(n).astype(np.float32)
    scores[100:140] = scores[60:100]            # ties
    scores[-30:] = -np.inf                      # padding ...
    boxes[-30:, :2] = 900.0                     # ... beyond every box
    seen = {}
    orig = tnms.rotated_nms

    def spy(b, *a):
        seen["shifted"] = b.numpy().copy()
        return orig(b, *a)

    monkeypatch.setattr(tnms, "rotated_nms", spy)
    for thr, post in ((0.2, 83), (0.5, 500)):
        want = jax.jit(jfn, static_argnames=("post_max_size",))(
            boxes, scores, labels, thr, post_max_size=post)
        got = tnms.batched_rotated_nms(t(boxes), t(scores), t(labels), thr,
                                       post)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert 30 < int(got[1].sum()) < n - 30
    extent = np.float32(np.abs(boxes[:, :2]).max() + boxes[:, 2:4].max()) \
        + np.float32(1.0)
    assert extent > 900
    shifted = np.asarray(jnp.asarray(boxes).at[:, 0].add(
        jnp.asarray(labels).astype(jnp.float32) * 2 * jnp.float32(extent)))
    np.testing.assert_array_equal(seen["shifted"], shifted)


@pytest.mark.parametrize("nms", [None, dict(nms_pre_max_size=1000,
                                            nms_post_max_size=83,
                                            nms_iou_threshold=0.2)],
                         ids=["defaults", "config"])
def test_per_class_post_process_matches_jax(rng, nms):
    """``center_head_post_process`` with ``per_class_nms`` on two samples of
    decoded 10-class boxes (9 columns): every candidate in (the config's
    ``nms_pre_max_size`` is not read), argmax ties to the lower class,
    boxes out of range masked; every output equal to JAX's."""
    from partner_tpu.models.center_head import \
        center_head_post_process as jpost
    from partner_tpu_torch.models.center_head import center_head_post_process

    n = 1200
    bev = np.stack([_clustered(rng, n, k=40, spread=65) for _ in range(2)])
    boxes = np.concatenate([bev[..., :2], rng.randn(2, n, 1),
                            bev[..., 2:4], rng.uniform(1, 3, (2, n, 1)),
                            rng.randn(2, n, 2), bev[..., 4:]],
                           -1).astype(np.float32)
    scores = rng.rand(2, n, 10).astype(np.float32)
    scores[:, :50] = scores[:, :50, :1]          # argmax ties
    scores[:, 50:90] = scores[:, 10:50]          # score ties
    tc = dict(post_center_limit_range=[-61.2, -61.2, -10.0, 61.2, 61.2,
                                       10.0],
              per_class_nms=True, score_threshold=0.1)
    if nms:
        tc["nms"] = nms
    want = jpost(jnp.asarray(boxes), jnp.asarray(scores), tc)
    got = center_head_post_process(t(boxes), t(scores), tc)
    assert got["mask"].shape == (2, 83)
    assert 40 < int(got["mask"].sum()) <= 2 * 83
    for k in ("box3d_lidar", "scores", "label_preds", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# --------------------------------------------------------------- detector

@pytest.fixture(scope="module")
def pair():
    """The tiny config in both packages from one drawn tree, and a batch of
    two cylinder-layout sweeps."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_centerpoint_cfg(SINGLEHEAD)
    jdet = jax_build(m, None, tc)
    v = nusc_jax_variables(jdet, np.random.RandomState(1))
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    pr = m["bbox_head"]["voxel_generator"]["range"]
    draws = [synthetic_points(np.random.RandomState(s), pr, 3000, 3600)
             for s in (0, 1)]
    ex = {"points": np.concatenate([d[0] for d in draws]),
          "points_mask": np.concatenate([d[1] for d in draws])}
    return dict(m=m, tc=tc, jdet=jdet, v=v, tdet=tdet, ex=ex)


def test_frame_matches_jax(pair):
    """``predict`` of both packages at batch 2: the head maps within
    ``MAP_TOL``; the per-class NMS's kept set, order and labels exact over
    the 16 x 32 map's candidates; the rectified boxes (9 columns) and
    scores within float32 rounding."""
    jdet, v, ex = pair["jdet"], pair["v"], pair["ex"]
    tex = {k: t(a) for k, a in ex.items()}
    jmaps = jax.jit(lambda v, e: jdet.module.apply(v, e, train=False))(v, ex)
    jout = {k: np.asarray(a) for k, a in jax.jit(jdet.predict)(v, ex).items()}
    with torch.no_grad():
        tmaps = pair["tdet"].module(tex)["det_preds"][0]
    tout = {k: a.numpy() for k, a in pair["tdet"].predict(tex).items()}
    jmaps = jmaps["det_preds"][0]
    assert tmaps["hm"].shape == (2, 32, 16, 10)
    for k in jmaps:
        np.testing.assert_allclose(tmaps[k].numpy(), np.asarray(jmaps[k]),
                                   rtol=MAP_TOL, atol=MAP_TOL, err_msg=k)
    assert tout["mask"].shape == jout["mask"].shape == (2, 64)
    assert tout["box3d_lidar"].shape[-1] == 9
    assert tout["mask"].sum() > 40
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    m = jout["mask"]
    np.testing.assert_allclose(tout["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def nusc_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("singlehead"))
    return root, write_tiny_nusc_set(root, seed=8)


def test_train_step_matches_jax(pair, nusc_set):
    """One step at batch 2 on a train batch of the config's pipeline (the
    rectified center targets of one 10-class task), from the shared
    converted tree, against ``jax.jit(make_train_step)``, by the rules of
    ``tests/test_torch_nusc_train.py``: the loss terms at rtol 1e-5, the
    gradient norm within 1e-5 or 3x the reference's own spread under a
    rounding-sized weight move; each gradient within ``GRAD_RMS``
    relative RMS, at the heads' output convs (``reg_out`` and each
    stack's last conv) within ``OUT_RMS``; a ``ConvGNStack``'s hidden conv
    bias, whose gradient the per-channel GroupNorm takes out, under 1e-5
    of the largest gradient on both sides; the parameters after the step
    within 2 lr of the start and at 2e-6 where Adam's first step is
    determined."""
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    root, info = nusc_set
    m, tc, jdet, v = pair["m"], pair["tc"], pair["jdet"], pair["v"]
    det = build_detector(m, None, tc, device="cpu")
    batch = nusc_batch(SINGLEHEAD, m, info, root, "train", 2, seed=6)
    ex = {k: batch[k] for k in det.loss_keys}
    assert len(ex["hm"]) == 1 and int(ex["mask"][0].sum()) > 5
    assert ex["anno_box"][0].shape[-1] == 10
    lr_max, total = 3e-3, 1000
    tx = jax_opt(lr_max=lr_max, total_steps=total)
    jstep = jax.jit(lambda s, e: jax_step(jdet, tx)(s, e,
                                                   jax.random.PRNGKey(1)))
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    new_state, jmet = jstep(create_train_state(v, tx), jex)
    moved_state, moved_met = jstep(create_train_state(
        four_ulp(v, np.random.RandomState(9)), tx), jex)

    load_converted(det.module, v)
    opt = build_one_cycle_optimizer(det.module, lr_max, total)
    met = make_train_step(det, opt)(
        {k: [t(a) for a in x] if isinstance(x, list) else t(x)
         for k, x in ex.items()}, torch.Generator().manual_seed(0))

    assert sorted(met) == sorted(jmet)
    for k in ("det_loss", "hm_loss", "loc_loss"):
        assert len(met[k]) == len(jmet[k]) == 1
        np.testing.assert_allclose(float(met[k][0]), float(jmet[k][0]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    norm, jnorm = float(met["grad_norm"]), float(jmet["grad_norm"])
    spread = abs(float(moved_met["grad_norm"]) - jnorm) / jnorm
    assert abs(norm - jnorm) / jnorm <= max(1e-5, 3 * spread), (norm, jnorm)

    b1 = np.float32(0.95)

    def grads(state):
        return flax_to_torch({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) / (np.float32(1) - b1),
            state.opt_state.inner_state[1].mu)})

    want = grads(new_state)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    scale = min(1.0, 35.0 / norm)
    params = dict(det.module.named_parameters())
    assert sorted(want) == sorted(params)
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in params.items():
        g, r = p.grad.numpy() * scale, want[name].numpy()
        if "_stack.Conv_0.bias" in name:
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-5 * gmax, name
            continue
        out = "reg_out." in name or "_stack.Conv_1." in name
        assert rel(g, r) <= (OUT_RMS if out else GRAD_RMS), (name, rel(g, r))

    lr0 = lr_max / 10.0
    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    sd = det.module.state_dict()
    assert sorted(after) == sorted(sd)
    n_loose = n_firm = n_all = 0
    for k, r in after.items():
        got, r = sd[k].numpy(), r.numpy()
        if k not in params:
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        assert np.all(np.abs(got - r) <= 2 * lr0 * 1.01 + 1e-6), k
        g, gr = params[k].grad.numpy() * scale, want[k].numpy()
        clear = np.abs(gr) > ADAM_CLEAR
        firm = clear & (np.abs(g - gr) <= 1e-2 * np.abs(gr))
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_loose += int((clear & (np.sign(g) != np.sign(gr))).sum())
        n_firm += int(firm.sum())
        n_all += firm.size
    assert n_loose <= 0.01 * n_all and n_firm >= 0.5 * n_all, (
        n_loose, n_firm, n_all)


# ------------------------------------------------------------ entry points

_PORT_CLIS = r"""
import json, os, sys
from partner_tpu_torch.tools import dist_test, train
cfg, work = sys.argv[1:3]
common = ["--device", "cpu", "--max_points", "5000"]
steps = train.main([cfg, "--work_dir", os.path.join(work, "train"),
                    "--batch_size", "2", "--total_steps", "2",
                    "--max_steps_per_epoch", "2"] + common)
results, fps = dist_test.main([
    cfg, "--checkpoint", os.path.join(work, "train", "latest"),
    "--work_dir", os.path.join(work, "eval")] + common)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "steps": steps, "metrics": results[0]}))
"""


def test_clis_on_the_cpu(nusc_set, tmp_path):
    """``train`` (two steps at batch 2, rectified targets, the per-task
    loss lists) then ``dist_test`` from its checkpoint, ``--device cpu``,
    in one fresh process that imports nothing of JAX: finite losses and
    nuScenes metrics, and every frame's kept boxes bit-equal to a direct
    ``predict`` of the same collated frame from that checkpoint."""
    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import load_checkpoint
    from partner_tpu_torch.utils.config import load_config

    root, info = nusc_set
    cfg_path = write_tiny_nusc_config(str(tmp_path / "cfg.py"), info, info,
                                      root, SINGLEHEAD)
    res = finish(port(["-c", _PORT_CLIS, cfg_path, str(tmp_path)]))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["steps"] == 2
    assert all(np.isfinite(got["metrics"][k]) for k in ("mAP", "NDS"))
    with open(tmp_path / "train" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(len(r["hm_loss"]) == 1 and np.isfinite(r["loss"])
               for r in recs)
    cfg = load_config(cfg_path)
    det = build_detector(cfg["model"], None, cfg["test_cfg"], device="cpu")
    det.module.load_state_dict(load_checkpoint(str(
        tmp_path / "train" / "latest"))[0]["state_dict"])
    with open(tmp_path / "eval" / "prediction.pkl", "rb") as f:
        preds = pickle.load(f)
    n = 0
    for b in DataLoader(build_dataset(dict(cfg["data"]["val"])), 1,
                        shuffle=False, max_points=5000):
        o = det.predict({k: t(b[k]) for k in ("points", "points_mask")})
        keep = o["mask"][0]
        p = preds[b["metadata"][0]["token"]]
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(p[k], o[k][0][keep].numpy(),
                                          err_msg=k)
        n += 1
    assert n == len(preds) == 4


def test_full_width_builds_with_jax_parameter_count():
    """The config at full width on the meta device: the stem at C_in 10,
    the 1024 x 1024 x 40 cylinder grid, the head's leaves and shapes equal
    to ``jax.eval_shape`` of the JAX detector's init (``reg_rs`` (8, 3, 3,
    64, 64), ``rot_vel_stack`` two conv groups, ``cal_*`` on the 5-wide
    encoding), ``per_class_nms`` and ``rectify`` in its test config."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, SINGLEHEAD))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    mod = det.module
    assert type(mod.bbox_head).__name__ == "CenterHeadSinglePos"
    assert mod.grid_size == (1024, 1024, 40)
    assert mod.backbone.stem0_kernel.shape[0] == 10
    assert det.test_cfg["per_class_nms"] and det.test_cfg["rectify"]
    ex = {"points": np.zeros((1, 64, 7), np.float32),
          "points_mask": np.zeros((1, 64), bool)}
    shapes = jax.eval_shape(lambda: jax_build(
        cfg["model"], cfg["train_cfg"], cfg["test_cfg"]).module.init(
        jax.random.PRNGKey(0), ex, train=False))
    want = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
    sd = mod.state_dict()
    assert sorted(want) == sorted(sd)
    for k, x in sd.items():
        assert tuple(want[k].shape) == tuple(x.shape), k
    assert tuple(sd["bbox_head.reg_rs.kernel"].shape) == (8, 3, 3, 64, 64)
    assert tuple(sd["bbox_head.rot_vel_stack.Conv_0.weight"].shape) == (
        64, 32, 3, 3)
    assert tuple(sd["bbox_head.cal_w0.weight"].shape) == (64, 5, 3, 3)
