"""The mesh's azimuth axis on gloo ranks of the CPU: the sharded neck of
VoxelNetV3 and VoxelNet (``--mesh azimuth=2``) and the two axes together
(``--mesh model=2,azimuth=2``, four ranks).

Two launches (``tests/torch_dist_cases.py``, ``mesh_step``), two ranks
and four, run at once. Each azimuth rank runs the backbone and the
SetBlock on the whole BEV map, the neck on its 16 of the tiny grid's 32
azimuth rows (a neighbour's row before each 3x3 conv, zeros past the
sweep's ends) with its BatchNorm statistics over data x azimuth, and
the heads on the all-gathered map; the loss's cotangent is scaled by 1/K
and the gradients summed over the azimuth group. Held, for the tiny
flagship (one neck scale widened to 128, so that the model axis slices
some kernels) and the tiny CenterPoint config:

- the eval-mode neck output of a frame within ``NECK_TOL`` (1 + |ref|)
  of the one-process module's and of JAX's forward under ``bev_pspec``
  (``P(None, "azimuth", None, None)`` on two virtual CPU devices);
- the neck alone on a random map: the output, and the gradients of
  ``sum(out * cot)`` by the map and the neck's parameters (each azimuth
  rank's part, summed over the ranks: the halo's backward) against the
  unsplit neck's;
- the train step (loss terms, gradients, parameters after Adam, the
  neck's BatchNorm running statistics) against the one-process step at
  ``tests/test_torch_dist.py``'s bounds (``hold_step``), the ranks ending
  bit-equal; the same for the four-rank ``model=2, azimuth=2`` step.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dist_cases as tdc
from test_torch_dist import hold_step
from test_torch_mesh_model import wide_tiny_cfg
from torch_port_fixtures import (CENTERPOINT, TINY_GRID, drawn_init,
                                 randomize, tiny_centerpoint_cfg)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NECK_TOL = 1e-5
LR_MAX = 3e-3


def _weights(m, tc, ex, rng):
    """Drawn JAX variables of ``m`` and the port's state_dict of them."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch

    jdet = jax_build(m, None, tc)
    v = randomize(drawn_init(jdet.module.init, rng, {
        "points": ex["points"][:, :64],
        "points_mask": ex["points_mask"][:, :64]}, train=False), rng)
    return v, flax_to_torch(v)


def _jax_bev(m, tc, v, ex):
    """JAX's eval forward under ``bev_pspec`` on an azimuth axis of two
    virtual CPU devices -> the neck's output map."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, 2, devices=jax.devices("cpu")[:2])
    jdet = jax_build(m, None, tc, bev_pspec=NamedSharding(
        mesh, P(None, "azimuth", None, None)))
    ex = {k: ex[k] for k in ("points", "points_mask")}
    with jax.sharding.set_mesh(mesh):
        _, bev = jax.jit(lambda vv, e: jdet.module.apply(
            vv, e, train=False, return_bev=True))(v, ex)
    return np.asarray(bev)


def _tasks():
    """The flagship and CenterPoint tasks: weights, a batch of 2, a random
    map and cotangent for the neck alone."""
    import chip_smoke

    from partner_tpu_torch.utils.config import load_config

    rng = np.random.RandomState(11)
    m, tc = wide_tiny_cfg()
    pr = m["bbox_head"]["voxel_generator"]["range"]
    ex = chip_smoke.train_example(np.random.RandomState(1), pr, TINY_GRID,
                                  2, 1200, 1500, 8)
    v, sd = _weights(m, tc, ex, rng)
    flagship = dict(kind="mesh_step", name="partner", model=m, test_cfg=tc,
                    state_dict=sd, example=ex, lr_max=LR_MAX, frame=True,
                    neck_x=rng.randn(2, 32, 16, 32).astype(np.float32),
                    neck_cot=rng.randn(2, 32, 16, 160).astype(np.float32))
    cm, ctc = tiny_centerpoint_cfg()
    train_cfg = load_config(os.path.join(ROOT, CENTERPOINT))["train_cfg"]
    cex = chip_smoke.centerpoint_train_example(
        np.random.RandomState(2), cm, train_cfg, 2, 1500, 1800, 12)
    cex = {k: cex[k] for k in ("points", "points_mask", "hm", "anno_box",
                               "ind", "mask", "cat")}
    cv, csd = _weights(cm, ctc, cex, rng)
    cp = dict(kind="mesh_step", name="centerpoint", model=cm, test_cfg=ctc,
              state_dict=csd, example=cex, lr_max=LR_MAX, frame=True,
              neck_x=rng.randn(2, 32, 16, 256).astype(np.float32),
              neck_cot=rng.randn(2, 32, 16, 64).astype(np.float32))
    return (flagship, v), (cp, cv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> ({name: two azimuth ranks' results}, the four ranks' results,
    {name: one-process result}, {name: JAX's neck output})."""
    (flagship, fv), (cp, cv) = _tasks()
    az = [dict(t, mesh=(1, 1, 2)) for t in (flagship, cp)]
    both = dict(flagship, name="model2_az2", mesh=(1, 2, 2), frame=False)
    both.pop("neck_x")
    h2 = tdc.start(az, str(tmp_path_factory.mktemp("az2")), world=2)
    h4 = tdc.start([both], str(tmp_path_factory.mktemp("m2az2")), world=4)
    jax_bev = {"partner": _jax_bev(flagship["model"], flagship["test_cfg"],
                                   fv, flagship["example"]),
               "centerpoint": _jax_bev(cp["model"], cp["test_cfg"], cv,
                                       cp["example"])}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {t["name"]: tdc.run_mesh_step(dict(t, mesh=(1, 1, 1)), 0, 1)
               for t in (flagship, cp)}
    finally:
        torch.set_num_threads(threads)
    return tdc.collect(h2), tdc.collect(h4)["model2_az2"], one, jax_bev


def _within(got, want, tol=NECK_TOL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want) / (1 + np.abs(want))
    assert got.shape == want.shape and err.max() <= tol, err.max()
    return float(err.max())


@pytest.mark.parametrize("name", ["partner", "centerpoint"])
def test_sharded_neck_output_as_one_process_and_jax(runs, name):
    """The eval-mode neck output of each azimuth rank (all-gathered) against
    the one-process module's and JAX's ``bev_pspec`` forward."""
    az, _, one, jax_bev = runs
    for r in az[name]:
        e1 = _within(r["bev"], one[name]["bev"])
        e2 = _within(r["bev"], jax_bev[name])
        print(f"{name} rank {r['coords']}: neck against one process "
              f"{e1!r}, against JAX {e2!r}")


@pytest.mark.parametrize("name", ["partner", "centerpoint"])
def test_halo_backward_as_the_unsplit_neck(runs, name):
    """The neck alone on a random map: each azimuth rank's gathered output
    against the unsplit neck's; its gradients by the map and by the neck's
    parameters, summed over the two ranks (each rank's rows, the halo's
    cotangent sent back to the neighbour that lent the row), against the
    unsplit neck's."""
    az, _, one, _ = runs
    ref = one[name]["neck"]
    for r in az[name]:
        _within(r["neck"]["y"], ref["y"])
    gx = sum(r["neck"]["x_grad"] for r in az[name])
    scale = float(ref["x_grad"].abs().max())
    _within(gx / scale, ref["x_grad"] / scale)
    for k, g in ref["param_grads"].items():
        got = sum(r["neck"]["param_grads"][k] for r in az[name])
        scale = max(float(g.abs().max()), 1e-30)
        _within(got / scale, g / scale)


@pytest.mark.parametrize("name", ["partner", "centerpoint",
                                  "model2_az2"])
def test_sharded_step_as_one_process(runs, name):
    """The train step on ``azimuth=2`` (both detectors) and on
    ``model=2, azimuth=2`` (the flagship, four ranks) against the
    one-process step at ``tests/test_torch_dist.py``'s bounds: the logged
    terms are the data-only step's, the gradients of every parameter
    (backbone, neck and head) the whole batch's, the neck's BatchNorm
    statistics those of the whole map; every rank ends bit-equal."""
    az, four, one, _ = runs
    ranks = four if name == "model2_az2" else az[name]
    want = one["partner" if name == "model2_az2" else name]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, t in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], t), k
    assert [r["coords"] for r in ranks] == (
        [(0, m, a) for m in range(2) for a in range(2)]
        if name == "model2_az2" else [(0, 0, 0), (0, 0, 1)])
    if name == "model2_az2":
        assert ranks[0]["sliced"]
    hold_step(ranks[0], want, "sign" if name != "centerpoint" else "agree",
              lr_max=LR_MAX)
