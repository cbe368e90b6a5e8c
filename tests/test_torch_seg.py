"""Segmentation in partner_tpu_torch against the JAX package (CPU, float32).

The det + seg PolarStream configs (``configs/nusc/pp/
polarstream_det_n_seg_*.py``: ``SingleConvHead`` over each sector's
canvas and neck map) cut as ``torch_port_fixtures.tiny_polarstream_cfg``
cuts the det configs, and the seg-only VoxelNet configs
(``configs/nusc/voxelnet/voxelnet_seg_{10sweep,cylinder}.py``:
``SpMiddleResNetFHD`` through voxel inputs, ``RPN``, ``DeconvConvHead``)
cut to ``VOXSEG_GRID``, on train batches of a synthetic nuScenes set with
lidarseg files (``write_tiny_nusc_set(..., lidarseg=True)``), one JAX
detector and one drawn, randomized flax tree per config:

- the lidarseg pipeline: every item and batch bit-equal, labels included;
- seg logits within 1e-5 relative RMS; each sector's (each grid's)
  majority labels and ``predict``'s ``point_seg_labels`` bit-equal; the
  loss terms within 1e-5 relative, under each ``seg_loss_decay`` rule;
- one train step of each family, the VoxelNet one through voxel inputs,
  by the gradient rules of ``tests/test_torch_nusc_train.py``;
- ``evaluate``'s mIoU and PQ equal to JAX's on the same predictions;
- both CLIs on a tiny det + seg and a tiny seg-only config with
  ``curriculum_weights``, and the full widths on the meta device.
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
from torch.overrides import TorchFunctionMode

from test_torch_centerpoint import finish, port
from test_torch_nusc_train import ADAM_CLEAR, GRAD_RMS, OUT_RMS, four_ulp
from torch_port_fixtures import (NUSC_SWEEPS, POLARSTREAM_SEG_CONFIGS,
                                 VOXELNET_SEG_CONFIGS, VOXSEG_GRID,
                                 drawn_init, load_converted, nusc_batch,
                                 randomize, tiny_polarstream_cfg,
                                 tiny_voxelnet_seg_cfg, write_tiny_nusc_set,
                                 write_tiny_polarstream_config,
                                 write_tiny_voxelnet_seg_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_RMS = 1e-5     # seg logits, float32 both sides
LOSS_RTOL = 1e-5
# a train-mode ReLU input this close to 0 can fall on either side of its
# kink in the two packages (their rounding apart at a deep block's BN
# output measured ~3e-6 RMS; the inputs that fell apart, -5.6e-7 and
# 1.2e-6): ``_step_against_jax``'s ``kinks``
KINK = 1e-5
KINK_TRIES = 4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tree(ex):
    return {k: [t(a) for a in v] if isinstance(v, list) else t(v)
            for k, v in ex.items()}


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """4 frames of ~1,500 points, 2 earlier sweeps each, and a lidarseg
    file a key frame -> (root, the infos' path)."""
    root = str(tmp_path_factory.mktemp("seg"))
    return root, write_tiny_nusc_set(root, seed=15, lidarseg=True)


# ------------------------------------------------------------ the data path

DATA_CONFIGS = {"polarstream": POLARSTREAM_SEG_CONFIGS["1_sector"],
                "cuboid": VOXELNET_SEG_CONFIGS["10sweep"],
                "cylinder": VOXELNET_SEG_CONFIGS["cylinder"]}


@pytest.mark.parametrize("name", list(DATA_CONFIGS))
def test_lidarseg_items_bit_equal(scene, name):
    """The config's train_pipeline on both sides from one seed (the point
    shuffle and the augmentations on, so the label column must travel
    with its row): every item bit-equal, ``pc_label`` included (the key
    frame's merged classes, -1 on the sweeps' rows), and the collated
    ``points_label`` (-1 clamped to 0) equal to JAX's collate; val items
    carry no labels."""
    import partner_tpu.data as jdata
    from partner_tpu.data.collate import collate as jcollate
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.collate import collate as tcollate
    from partner_tpu_torch.utils.config import load_config

    root, info = scene
    cfg = load_config(os.path.join(ROOT, DATA_CONFIGS[name]))
    out = {}
    for mode in ("train", "val"):
        ds = copy.deepcopy(cfg["data"][mode])
        ds.update(info_path=info, root_path=root, nsweeps=NUSC_SWEEPS)
        np.random.seed(21)
        jds = jdata.build_dataset(copy.deepcopy(ds))
        tds = tdata.build_dataset(copy.deepcopy(ds),
                                  dict(rng=np.random.RandomState(21)))
        jitems = [jds[i] for i in range(len(jds))]
        titems = [tds[i] for i in range(len(tds))]
        for j, g in zip(jitems, titems):
            assert sorted(g) == sorted(j)
            for k in ("points", "pc_label"):
                if k in j:
                    assert g[k].dtype == j[k].dtype
                    np.testing.assert_array_equal(g[k], j[k], err_msg=k)
        jb = jcollate(jitems[:2], max_points=8000)
        tb = tcollate(titems[:2], max_points=8000)
        for k in ("points", "points_mask", "points_label"):
            assert (k in tb) == (k in jb)
            if k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        out[mode] = titems, tb
    titems, tb = out["train"]
    assert "pc_label" not in out["val"][0][0]
    n_key = titems[0]["metadata"]["n_key_points"]
    lab = titems[0]["pc_label"][:, 0]
    assert len(lab) == len(titems[0]["points"]) > n_key
    assert (lab == -1).sum() == len(lab) - n_key   # the sweeps' rows
    assert set(np.unique(lab[lab >= 0])) <= set(range(17))
    assert len(np.unique(lab)) > 5
    assert tb["points_label"].min() == 0 and tb["points_label"].max() <= 16


# -------------------------------------------------------- PolarStream seg

DECAYS = (None, 0.5, -1.0)   # no seg_loss_decay, a decay, the dynamic one


def _jax_run(jdet):
    """The JAX maps, ``predict`` and eval-mode loss of one jitted call."""
    def run(v, e):
        return (jdet.module.apply(v, e, train=False), jdet.predict(v, e),
                jdet.loss(v, e, train=False)[0])

    return run


def _decayed(jloss, decay, n_sec):
    """JAX's loss dict under ``seg_loss_decay``: its ``apply_seg_decay``
    over the undecayed run's det total (the sector losses' sum, 0 without
    a CenterHead) and seg total (``seg_loss`` x S, exact for S = 1, 4)."""
    from partner_tpu.models.detectors import apply_seg_decay

    if decay is None:
        return jloss
    det = sum((jloss[k] for k in jloss if k.startswith("sector")),
              jnp.float32(0))
    total = apply_seg_decay(det, jloss["seg_loss"] * n_sec,
                            {"seg_loss_decay": np.float32(decay)})
    return dict(jloss, loss=total / n_sec)


@pytest.fixture(scope="module", params=["1_sector", "4_sector_bidirectional"])
def polar(request, scene):
    """One det + seg config in both packages from one drawn, randomized
    tree, a train batch of two samples through the port's pipeline, and
    JAX's maps, ``predict`` and eval-mode loss of one jitted call."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    root, info = scene
    config = POLARSTREAM_SEG_CONFIGS[request.param]
    m, tc = tiny_polarstream_cfg(config)
    batch = nusc_batch(config, m, info, root, "train", 2, seed=4)
    tdet = build_detector(m, None, tc, device="cpu")
    ex = {k: batch[k] for k in tdet.loss_keys}
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(11)
    v = randomize(drawn_init(jdet.module.init, rng, {
        k: ex[k] for k in ("points", "points_mask")}, train=False), rng)
    load_converted(tdet.module, v)

    jmaps, jout, jloss = jax.jit(_jax_run(jdet))(v, jax.tree_util.tree_map(
        jnp.asarray, ex))
    return dict(m=m, tc=tc, jdet=jdet, tdet=tdet, v=v, ex=ex,
                jmaps=jmaps, jout=jout, jloss=jloss)


def test_polarstream_seg_maps_match_jax(polar):
    """Each sector's seg map ((2, 128 / S, 64, 16): the canvas's 16
    channels and the neck's 48 grown x4, a 1 x 1 conv) within
    ``LOGIT_RMS``."""
    tdet = polar["tdet"]
    with torch.no_grad():
        got = tdet.module(tree(polar["ex"]))["seg_preds"]
    want = polar["jmaps"]["seg_preds"]
    n = tdet.module.n_sectors
    assert len(got) == len(want) == n
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, 128 // n, 64, 16)
        assert rel_rms(g.numpy(), w) <= LOGIT_RMS, s


def test_polarstream_seg_labels_match_jax(polar):
    """Each sector's ``point_cells`` and ``majority_cell_labels`` bit-equal
    to JAX's (a cell's label is its points' majority, class 0 never, ties
    to the lower class), and ``predict``'s ``point_seg_labels`` (summed
    over the sectors) and detections equal."""
    from partner_tpu.models.polarstream import \
        majority_cell_labels as jmajority
    from partner_tpu_torch.models.polarstream import majority_cell_labels

    jdet, tdet, ex = polar["jdet"], polar["tdet"], polar["ex"]
    mod = tdet.module
    n_labelled = 0
    for s in range(mod.n_sectors):
        want = jdet.module.apply(polar["v"], ex["points"],
                                 ex["points_mask"], s,
                                 method=type(jdet.module).point_cells)
        got = mod.point_cells(t(ex["points"]), t(ex["points_mask"]), s)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        wl = np.asarray(jmajority(*want, jnp.asarray(ex["points_label"]),
                                  mod.sector_grid(), 16))
        gl = majority_cell_labels(*got, t(ex["points_label"]),
                                  mod.sector_grid(), 16).numpy()
        np.testing.assert_array_equal(gl, wl)
        n_labelled += int((gl > 0).sum())
    assert n_labelled > 500
    out = {k: v.numpy() for k, v in tdet.predict(tree(ex)).items()}
    jout = {k: np.asarray(v) for k, v in polar["jout"].items()}
    assert sorted(out) == sorted(jout)
    np.testing.assert_array_equal(out["point_seg_labels"],
                                  jout["point_seg_labels"])
    np.testing.assert_array_equal(out["mask"], jout["mask"])
    assert (out["point_seg_labels"][ex["points_mask"]] > 0).mean() > 0.9


@pytest.mark.parametrize("decay", DECAYS)
def test_polarstream_seg_loss_matches_jax(polar, decay):
    """The eval-mode loss terms (``sector{s}_loss``, ``seg_loss`` = the
    sectors' sum / S, ``loss``) within ``LOSS_RTOL`` of JAX's, with no
    ``seg_loss_decay``, a decay, and a negative one (det / seg, the
    dynamic balance; JAX's ``apply_seg_decay`` over its own terms)."""
    tdet = polar["tdet"]
    ex = dict(polar["ex"])
    if decay is not None:
        ex["seg_loss_decay"] = np.float32(decay)
    want = _decayed(polar["jloss"], decay, tdet.module.n_sectors)
    tdet.module.eval()
    with torch.no_grad():
        got = tdet.loss(tree(ex))
    assert sorted(got) == sorted(want)
    assert "seg_loss" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    if decay == -1.0:    # det + seg x (det / seg): twice the det total
        det = sum(float(got[k]) for k in got if k.startswith("sector"))
        np.testing.assert_allclose(float(got["loss"]),
                                   2 * det / tdet.module.n_sectors,
                                   rtol=1e-5)


# -------------------------------------------------------- seg-only VoxelNet

def voxel_example(tdet, m, batch):
    """The train batch's points voxelized on the CPU by the port's
    ``DeviceVoxelizer`` (bit-equal to JAX's ``dynamic_voxelize``, PR 11)
    beside the points and their labels, as numpy."""
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    vg = m["seg_head"]["voxel_generator"]
    vox = DeviceVoxelizer(vg, "cpu", vg["max_voxel_num"][0])(
        t(batch["points"]), t(batch["points_mask"]))
    ex = {k: batch[k] for k in tdet.loss_keys}
    ex.update({k: v.numpy() for k, v in vox.items()})
    return ex


@pytest.fixture(scope="module", params=list(VOXELNET_SEG_CONFIGS))
def voxseg(request, scene):
    """One seg-only config in both packages from one drawn, randomized
    tree; a train batch of two samples voxelized; JAX's maps, ``predict``
    and eval-mode loss of one jitted call."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    root, info = scene
    config = VOXELNET_SEG_CONFIGS[request.param]
    m, tc = tiny_voxelnet_seg_cfg(config)
    tdet = build_detector(m, None, tc, device="cpu")
    batch = nusc_batch(config, m, info, root, "train", 2, seed=5)
    ex = voxel_example(tdet, m, batch)
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(12)
    v = randomize(drawn_init(jdet.module.init, rng, {
        k: ex[k] for k in ("features", "coords", "voxel_mask")},
        train=False), rng)
    load_converted(tdet.module, v)

    jmaps, jout, jloss = jax.jit(_jax_run(jdet))(v, jax.tree_util.tree_map(
        jnp.asarray, ex))
    return dict(name=request.param, m=m, tc=tc, jdet=jdet, tdet=tdet, v=v,
                ex=ex, jmaps=jmaps, jout=jout, jloss=jloss)


def test_voxelnet_seg_matches_jax(voxseg):
    """The seg-only VoxelNet through voxel inputs: no CenterHead (no
    ``det_preds``; ``loss_keys`` the points and their labels), the seg map
    on the BEV grid (2, 16, 8, 16) as JAX's (the backbone's BEV map is the
    canvas; its deconv output 122 x 58 shrinks back, antialiased) within
    ``LOGIT_RMS``; the majority labels of that grid and ``predict``'s
    ``point_seg_labels`` bit-equal; the eval-mode ``seg_loss`` and
    ``loss`` within ``LOSS_RTOL``; ``predict`` gives the labels alone."""
    from partner_tpu.models import seg_head as js
    from partner_tpu_torch.models import seg_head as ts

    tdet, ex = voxseg["tdet"], voxseg["ex"]
    assert tdet.input_kind == "voxels" and tdet.module.bbox_head is None
    assert tdet.loss_keys == ("points", "points_mask", "points_label")
    with torch.no_grad():
        maps = tdet.module(tree(ex))
    assert sorted(maps) == sorted(voxseg["jmaps"]) == ["seg_preds"]
    sp, wsp = maps["seg_preds"].numpy(), np.asarray(
        voxseg["jmaps"]["seg_preds"])
    assert sp.shape == wsp.shape == (2, VOXSEG_GRID[1] // 8,
                                     VOXSEG_GRID[0] // 8, 16)
    assert rel_rms(sp, wsp) <= LOGIT_RMS
    shape = sp.shape[1:3]
    pr = tdet.module.pc_range
    gi, ok = ts.points_to_grid_cells(t(ex["points"]), t(ex["points_mask"]),
                                     shape, pr, tdet.voxel_shape)
    wgi, wok = js.points_to_grid_cells(jnp.asarray(ex["points"]),
                                       jnp.asarray(ex["points_mask"]),
                                       shape, pr, tdet.voxel_shape)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    got = ts.majority_grid_labels(gi, ok, t(ex["points_label"]), shape,
                                  16).numpy()
    want = np.asarray(js.majority_grid_labels(
        wgi, wok, jnp.asarray(ex["points_label"]), shape, 16))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.3
    out = {k: v.numpy() for k, v in tdet.predict(tree(ex)).items()}
    assert sorted(out) == sorted(voxseg["jout"]) == ["point_seg_labels"]
    np.testing.assert_array_equal(out["point_seg_labels"],
                                  np.asarray(voxseg["jout"][
                                      "point_seg_labels"]))
    tdet.module.eval()
    for decay in DECAYS:
        want = _decayed(voxseg["jloss"], decay, 1)
        exd = ex if decay is None else dict(ex, seg_loss_decay=decay)
        with torch.no_grad():
            loss = tdet.loss(tree(exd))
        assert sorted(loss) == sorted(want) == ["loss", "seg_loss"]
        for k in loss:
            np.testing.assert_allclose(float(loss[k]), float(want[k]),
                                       rtol=LOSS_RTOL, err_msg=(decay, k))


# ------------------------------------------------------------ train steps

class FlipReLU(TorchFunctionMode):
    """Watches the ``relu`` calls of a port forward: records each nonzero
    input within ``KINK`` of 0 as (|x|, call, flat index) in ``near``, and
    with ``at`` = (call, flat index) puts that one input on the other side
    of its kink (out x and gradient 1 where x <= 0, out 0 and gradient 0
    where x > 0). Every other output is the plain ``relu``'s."""

    def __init__(self, at=None):
        super().__init__()
        self.at, self.calls, self.near = at, 0, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") != "relu":
            return out
        x, i = args[0], self.calls
        self.calls += 1
        flat = x.detach().reshape(-1)
        near = ((flat != 0) & (flat.abs() < KINK)).nonzero().flatten()
        self.near += [(float(flat[j].abs()), i, int(j)) for j in near]
        if self.at is None or self.at[0] != i:
            return out
        on = (flat > 0).clone()
        on[self.at[1]] = ~on[self.at[1]]
        return torch.where(on.reshape(x.shape), x, torch.zeros_like(x))


def _step_against_jax(jdet, tdet, v, ex, lr_max=3e-3, total=1000,
                      kinks=False):
    """One port train step and one ``jax.jit(make_train_step)`` step from
    the same tree (and one from the tree moved by four ulps), held by the
    rules of ``tests/test_torch_nusc_train.py``: the loss terms at 1e-5,
    the gradient norm within 1e-5 or 3x the reference's spread under the
    move, each gradient within ``GRAD_RMS`` (``OUT_RMS`` for output
    convs) or 3x that spread, the BatchNorm statistics at 1e-5, and the
    parameters within 2 lr of the start and at 2e-6 where Adam's first
    step is determined. -> the port's metrics.

    ``kinks``: at random weights a train-mode ReLU input can lie within
    rounding of 0, and the two packages then take opposite sides of its
    kink: the gradient of every leaf upstream jumps by a piece (1.6-4.3%
    measured), while the loss moves by the input's size. Where a gradient
    misses its bound and ``kinks`` is set, the port's step is taken again
    from the same tree with one ReLU input within ``KINK`` of 0 on its
    other side (:class:`FlipReLU`; the ``KINK_TRIES`` closest, one at a
    time), and the first such step that meets every rule above, at every
    leaf, is the one held. Off by default."""
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    tx = jax_opt(lr_max=lr_max, total_steps=total)
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    jstep = jax.jit(lambda s: jax_step(jdet, tx)(s, jex,
                                                  jax.random.PRNGKey(1)))
    new_state, jmet = jstep(create_train_state(v, tx))
    moved_state, moved_met = jstep(create_train_state(
        four_ulp(v, np.random.RandomState(9)), tx))

    def port_step(at=None):
        load_converted(tdet.module, v)
        opt = build_one_cycle_optimizer(tdet.module, lr_max, total)
        with FlipReLU(at) as mode:
            met = make_train_step(tdet, opt)(tree(ex),
                                             torch.Generator().manual_seed(0))
        return met, sorted(mode.near)

    b1 = np.float32(0.95)

    def grads(state):
        return flax_to_torch({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) / (np.float32(1) - b1),
            state.opt_state.inner_state[1].mu)})

    want, moved = grads(new_state), grads(moved_state)
    floats = lambda x: [float(y) for y in (x if isinstance(x, list) else [x])]

    def misses(met):
        """The loss terms and the gradient norm held here; -> (scale, the
        gradient leaves beyond their bounds)."""
        assert sorted(met) == sorted(jmet)
        for k in sorted(met):
            if k != "grad_norm":   # a CenterPoint loss gives per-task lists
                np.testing.assert_allclose(floats(met[k]), floats(jmet[k]),
                                           rtol=LOSS_RTOL, err_msg=k)
        norm, jnorm = float(met["grad_norm"]), float(jmet["grad_norm"])
        spread = abs(float(moved_met["grad_norm"]) - jnorm) / jnorm
        scale = min(1.0, 35.0 / norm)
        params = dict(tdet.module.named_parameters())
        assert sorted(want) == sorted(params)
        gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
        bad = [] if abs(norm - jnorm) / jnorm <= max(1e-5, 3 * spread) else [
            ("grad_norm", norm, jnorm, spread)]
        for name, p in params.items():
            g, r = p.grad.numpy() * scale, want[name].numpy()
            if "_stack.Conv_0.bias" in name:
                assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-5 * gmax, \
                    name
                continue
            out = ("reg_out." in name or "_stack.Conv_1." in name
                   or name.startswith("seg_head."))
            bound = max(OUT_RMS if out else GRAD_RMS,
                        3 * rel_rms(moved[name].numpy(), r))
            if rel_rms(g, r) > bound:
                bad.append((name, rel_rms(g, r), bound))
        return scale, bad

    met, near = port_step()
    scale, bad = misses(met)
    for _, call, j in (near[:KINK_TRIES] if bad and kinks else []):
        met = port_step((call, j))[0]
        scale, flipped_bad = misses(met)
        if not flipped_bad:
            bad = []
            break
    assert not bad, (bad, near[:KINK_TRIES])
    params = dict(tdet.module.named_parameters())

    lr0 = lr_max / 10.0
    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    sd = tdet.module.state_dict()
    assert sorted(after) == sorted(sd)
    n_firm = n_all = 0
    for k, r in after.items():
        got, r = sd[k].numpy(), r.numpy()
        if k not in params:
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        assert np.all(np.abs(got - r) <= 2 * lr0 * 1.01 + 1e-6), k
        g, gr = params[k].grad.numpy() * scale, want[k].numpy()
        firm = (np.abs(gr) > ADAM_CLEAR) & (np.abs(g - gr)
                                            <= 1e-2 * np.abs(gr))
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_firm += int(firm.sum())
        n_all += firm.size
    assert n_firm >= 0.5 * n_all, (n_firm, n_all)
    return met


@pytest.mark.parametrize("voxseg", ["cylinder"], indirect=True)
def test_voxelnet_seg_train_step_matches_jax(voxseg):
    """One seg-only step of the cylinder config through voxel inputs
    (``make_train_step`` takes the voxels, the points and their labels, as
    JAX's does): ``seg_loss`` and ``loss`` with a curriculum decay of 0.5,
    the gradients by the rules of :func:`_step_against_jax`."""
    ex = dict(voxseg["ex"], seg_loss_decay=np.float32(0.5))
    try:
        met = _step_against_jax(voxseg["jdet"], voxseg["tdet"], voxseg["v"],
                                ex)
    finally:   # the shared detector back at the fixture's weights
        load_converted(voxseg["tdet"].module, voxseg["v"])
    assert sorted(met) == ["grad_norm", "loss", "seg_loss"]
    np.testing.assert_allclose(float(met["loss"]),
                               0.5 * float(met["seg_loss"]), rtol=1e-6)


# ------------------------------------------------------------- evaluation

class _Planted:
    """Per-frame outputs of a seg + det detector, planted from each val
    frame's files: the lidarseg classes with 20% of the points moved to
    another class, and the frame's gt boxes kept at score 0.9. A frame is
    told by its first point."""

    def __init__(self, infos, rows):
        from partner_tpu_torch.data.pipeline import read_lidarseg

        rng = np.random.RandomState(17)
        self.frames = {}
        for info in infos:
            key = np.fromfile(info["lidar_path"], np.float32).reshape(-1, 5)
            lab = np.zeros(rows, np.int64)
            gt = read_lidarseg(info["lidarseg_path"])
            noisy = rng.rand(len(gt)) < 0.2
            gt[noisy] = rng.randint(0, 17, int(noisy.sum()))
            lab[:len(gt)] = gt
            boxes = np.zeros((64, 7), np.float32)
            n = len(info["gt_boxes"])
            boxes[:n] = info["gt_boxes"][:, [0, 1, 2, 3, 4, 5, 8]]
            labels = np.full(64, -1, np.int32)
            labels[:n] = [list(NUSC_NAMES).index(c) for c in info["gt_names"]]
            self.frames[float(key[0, 0])] = dict(
                point_seg_labels=lab, box3d_lidar=boxes,
                scores=np.where(labels >= 0, 0.9, 0).astype(np.float32),
                label_preds=labels, mask=labels >= 0)

    def outputs(self, points, x_col):
        rows = [self.frames[float(p[0, x_col])] for p in points]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


NUSC_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer",
              "barrier", "motorcycle", "bicycle", "pedestrian",
              "traffic_cone")


def test_evaluate_seg_matches_jax(scene, tmp_path, monkeypatch):
    """``evaluate`` over the val set of a det + seg config (the first
    points' rows the key frame's; their cylinder xy columns for the
    panoptic fusion), the port's and JAX's engines fed the same planted
    outputs: the 3-tuple equal, the mIoU and PQ bit for bit, and a
    seg-only detector's empty ``prediction.pkl``. Both loaders run one
    thread: with more, frames come in the order the threads finish them,
    and PQ sums its per-frame IoUs in that order (the last bit moves)."""
    import logging

    import partner_tpu.data as jdata
    from partner_tpu.eval.evaluator import evaluate as jevaluate
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.eval import evaluator as tevaluator
    from partner_tpu_torch.eval.evaluator import evaluate
    from partner_tpu_torch.utils.config import load_config

    for mod in (jdata, tevaluator):
        orig = mod.build_dataloader
        monkeypatch.setattr(mod, "build_dataloader", (
            lambda orig: lambda ds, bs, **kw: orig(
                ds, bs, **dict(kw, workers_per_gpu=1)))(orig))

    root, info = scene
    cfg = load_config(os.path.join(ROOT, POLARSTREAM_SEG_CONFIGS[
        "1_sector"]))
    ds = copy.deepcopy(cfg["data"]["val"])
    ds.update(info_path=info, root_path=root, nsweeps=NUSC_SWEEPS)
    with open(info, "rb") as f:
        infos = pickle.load(f)
    rows = 6000
    planted = _Planted(infos, rows)

    def jax_predict(variables, points, pmask):
        # cylinder rows [rho, phi, z, x, y, ...]: x is column 3
        return planted.outputs(np.asarray(points), 3)

    logger = logging.getLogger("test_torch_seg")
    np.random.seed(0)
    want, _ = jevaluate(None, cfg, jdata.build_dataset(copy.deepcopy(ds)),
                        None, str(tmp_path), logger, max_points=rows,
                        input_kind="points", predict_fn=jax_predict)

    class Det:
        input_kind = "points"
        voxel_shape = "cylinder"

        def __init__(self, keys):
            self.keys = keys

        def predict(self, ex):
            out = planted.outputs(ex["points"].numpy(), 3)
            return {k: t(out[k]) for k in self.keys}

    keys = ("point_seg_labels", "box3d_lidar", "scores", "label_preds",
            "mask")
    for d in ("t", "s"):
        os.makedirs(tmp_path / d)
    got, _ = evaluate(Det(keys), tdata.build_dataset(
        copy.deepcopy(ds), dict(rng=np.random.RandomState(0))),
        str(tmp_path / "t"), logger, "cpu", max_points=rows, cfg=cfg)
    assert len(got) == len(want) == 3
    assert got[1] == want[1] and got[2] == want[2]
    assert 0.3 < got[1] < 1 and 0 < got[2]["PQ"] < 1
    for k in ("mAP", "NDS"):
        assert got[0][k] == want[0][k]
    seg_only, _ = evaluate(Det(keys[:1]), tdata.build_dataset(
        copy.deepcopy(ds), dict(rng=np.random.RandomState(0))),
        str(tmp_path / "s"), logger, "cpu", max_points=rows, cfg=cfg)
    with open(tmp_path / "s" / "prediction.pkl", "rb") as f:
        assert pickle.load(f) == {}
    # no boxes: every thing point in instance 0, one segment a class, as
    # the gt (no info carries instance_ids)
    assert seg_only[0] is None and seg_only[1] == got[1]
    assert seg_only[2] != got[2] and 0 < seg_only[2]["PQ"] < 1


# ------------------------------------------------------------ entry points

_PORT_CLIS = r"""
import json, os, pickle, sys
import numpy as np, torch
from partner_tpu_torch.data import build_dataset
from partner_tpu_torch.data.loader import DataLoader
from partner_tpu_torch.eval import evaluator
from partner_tpu_torch.models import build_detector
from partner_tpu_torch.tools import dist_test, train
from partner_tpu_torch.train.checkpoint import load_checkpoint
from partner_tpu_torch.utils.config import load_config
work = sys.argv[1]
orig = evaluator.build_dataloader
# one loader thread: each frame draws its sweep order in frame order
evaluator.build_dataloader = lambda ds, bs, **kw: orig(
    ds, bs, **dict(kw, workers_per_gpu=1))
out = {}
for cfg in sys.argv[2:]:
    name = os.path.splitext(os.path.basename(cfg))[0]
    common = ["--device", "cpu", "--max_points", "5000"]
    steps = train.main([cfg, "--work_dir", os.path.join(work, name, "train"),
                        "--batch_size", "2", "--total_steps", "2",
                        "--max_steps_per_epoch", "1"] + common)
    ckpt = os.path.join(work, name, "train", "latest")
    result, fps = dist_test.main([
        cfg, "--checkpoint", ckpt,
        "--work_dir", os.path.join(work, name, "eval")] + common)
    c = load_config(cfg)
    det = build_detector(c["model"], None, c["test_cfg"], device="cpu")
    det.module.load_state_dict(load_checkpoint(ckpt)[0]["state_dict"])
    vox = None
    if det.input_kind == "voxels":
        vg = c["voxel_generator"]
        vox = evaluator.DeviceVoxelizer(vg, "cpu", vg["max_voxel_num"][1])
    ds = build_dataset(dict(c["data"]["val"]))
    preds, frames = {}, {}
    for b in DataLoader(ds, 1, shuffle=False, num_workers=1,
                        max_points=5000):
        ex = {k: torch.from_numpy(b[k]) for k in ("points", "points_mask")}
        if vox is not None:
            ex.update(vox(ex["points"], ex["points_mask"]))
        o = {k: v[0].numpy() for k, v in det.predict(ex).items()}
        meta = b["metadata"][0]
        n = meta["n_key_points"]
        frames[meta["token"]] = {"labels": o["point_seg_labels"][:n],
                                 "xy": b["points"][0][:n, 3:5]}
        if "mask" in o:
            preds[meta["token"]] = {k: o[k][o["mask"]] for k in (
                "box3d_lidar", "scores", "label_preds")}
    kw = evaluator.seg_inputs(ds, preds, frames)
    again = ds.evaluation(preds, os.path.join(work, name, "again"), **kw)
    with open(os.path.join(work, name, "seg_inputs.pkl"), "wb") as f:
        pickle.dump((preds, kw), f)
    out[name] = {"steps": steps, "seg": result[1], "pan": result[2],
                 "again": [again[1], again[2]], "det": result[0] is not None,
                 "empty": os.path.getsize(os.path.join(
                     work, name, "eval", "prediction.pkl"))}
out["bad"] = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                     "partner_tpu")]
print(json.dumps(out))
"""


def test_clis_on_the_cpu(scene, tmp_path):
    """A tiny det + seg PolarStream config (curriculum_weights [-1.0]: the
    dynamic balance) and a tiny seg-only VoxelNet config
    (curriculum_weights [0.5]) through ``train`` (two steps at batch 2,
    one an epoch: the second takes the weight 1.0 past the list's end;
    the VoxelNet one voxelizes each batch) and ``dist_test`` from its
    checkpoint (the VoxelNet one through voxel inputs), ``--device cpu``,
    in one fresh process that imports nothing of JAX: the logged
    ``seg_loss`` and ``loss`` follow the weights; ``dist_test``'s mIoU and
    PQ equal those of the frames' direct ``predict`` in that process, and
    JAX's ``NuScenesDataset.evaluation`` of those same inputs; the
    seg-only run's ``prediction.pkl`` is empty."""
    from partner_tpu.data.datasets import NuScenesDataset

    root, info = scene
    cfgs = {
        "polar": write_tiny_polarstream_config(
            str(tmp_path / "polar.py"), info, info, root,
            POLARSTREAM_SEG_CONFIGS["1_sector"]),
        "voxseg": write_tiny_voxelnet_seg_config(
            str(tmp_path / "voxseg.py"), info, info, root,
            VOXELNET_SEG_CONFIGS["10sweep"])}
    for name, w in (("polar", -1.0), ("voxseg", 0.5)):
        with open(cfgs[name], "a") as f:
            f.write(f"curriculum_weights = [{w}]\n")
    res = finish(port(["-c", _PORT_CLIS, str(tmp_path)] + list(
        cfgs.values())))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got.pop("bad") == []
    for name, w in (("polar", -1.0), ("voxseg", 0.5)):
        run = got[name]
        assert run["steps"] == 2
        assert run["det"] == (name == "polar")
        assert 0 < run["seg"] < 1 and np.isfinite(run["pan"]["PQ"])
        assert [run["seg"], run["pan"]] == run["again"]
        with open(tmp_path / name / "seg_inputs.pkl", "rb") as f:
            preds, kw = pickle.load(f)
        jds = NuScenesDataset(info_path=info, root_path=root,
                              nsweeps=NUSC_SWEEPS, pipeline=[])
        want = jds.evaluation(preds, str(tmp_path / name / "jax"), **kw)
        assert [run["seg"], run["pan"]] == [want[1], want[2]]
        if name == "voxseg":
            assert preds == {} and run["empty"] < 20
        with open(tmp_path / name / "train" / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs] == [0, 1]
        for r, weight in zip(recs, (w, 1.0)):
            seg = r["seg_loss"]
            assert np.isfinite(seg) and np.isfinite(r["grad_norm"])
            if name == "voxseg":
                np.testing.assert_allclose(r["loss"], weight * seg,
                                           rtol=1e-6)
            elif weight < 0:     # det + seg x det / seg = 2 det
                det = r["sector0_loss"]
                np.testing.assert_allclose(r["loss"], 2 * det, rtol=1e-5)
            else:
                np.testing.assert_allclose(r["loss"],
                                           r["sector0_loss"] + seg,
                                           rtol=1e-5)


# ------------------------------------------------------------- full width

@pytest.mark.parametrize("name", list(POLARSTREAM_SEG_CONFIGS)
                         + list(VOXELNET_SEG_CONFIGS))
def test_full_width_builds_with_jax_parameter_count(name):
    """Each of the five seg configs at full width on the meta device, its
    seg head's widths as flax infers them (PolarStream: the 128-channel
    canvas and the 384-channel neck map into a 1 x 1 conv to 16 classes;
    VoxelNet: the sparse backbone's 256-channel BEV (the config's neck
    ``num_input_features`` of 128 is not read) and the deconv's 40
    channels (``height``), the 512-channel neck map into a 16 x 16
    stride-8 deconv), and every leaf's name and shape equal to
    ``jax.eval_shape`` of the JAX detector's init."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    config = dict(POLARSTREAM_SEG_CONFIGS, **VOXELNET_SEG_CONFIGS)[name]
    cfg = load_config(os.path.join(ROOT, config))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    head = det.module.seg_head
    if name in POLARSTREAM_SEG_CONFIGS:
        assert tuple(head.Conv_0.weight.shape) == (16, 512, 1, 1)
        assert det.seg_weight == 2
        ex = {"points": np.zeros((1, 64, 7), np.float32),
              "points_mask": np.zeros((1, 64), bool)}
    else:
        assert det.module.grid_size == {"10sweep": (512, 512, 40),
                                        "cylinder": (640, 640, 40)}[name]
        assert tuple(head.ConvTranspose_0.weight.shape) == (512, 40, 16, 16)
        assert tuple(head.Conv_0.weight.shape) == (16, 296, 1, 1)
        assert det.input_kind == "voxels" and det.seg_weight == 1
        c = cfg["model"]["reader"]["num_input_features"]
        ex = {"features": np.zeros((1, 64, c), np.float32),
              "coords": np.zeros((1, 64, 3), np.int32),
              "voxel_mask": np.zeros((1, 64), bool)}
    shapes = jax.eval_shape(lambda: jax_build(
        cfg["model"], cfg["train_cfg"], cfg["test_cfg"]).module.init(
        jax.random.PRNGKey(0), ex, train=False))
    want = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
    sd = det.module.state_dict()
    assert sorted(want) == sorted(sd)
    for k, x in sd.items():
        assert tuple(want[k].shape) == tuple(x.shape), k
