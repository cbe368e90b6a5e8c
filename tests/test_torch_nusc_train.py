"""The nuScenes CenterPoint configs in partner_tpu_torch against the JAX
package (CPU, float32): one train step.

Each of the three configs cut as ``tests/test_torch_nusc_frame.py`` cuts
them, one step at batch 2 on a train batch of the port's data path (the
config's train pipeline over a synthetic nuScenes set: flips, rotation,
scaling, the six tasks' center targets), from the same converted weights,
against ``jax.jit(make_train_step(det, tx))``: the per-task loss terms,
the gradients (the JAX step's own, read back from Adam's first moment),
and the parameters and batch statistics after the step, by the rules
``test_train_step_matches_jax`` states (those of the Waymo step test in
``tests/test_torch_centerpoint.py``, but for the gradients upstream of
the heads). The DCN heads' backward runs through the plain deformable
conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (NUSC_CONFIGS as CONFIGS, load_converted,
                                 nusc_batch, nusc_jax_variables,
                                 tiny_centerpoint_cfg, write_tiny_nusc_set)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nusc_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_train"))
    return root, write_tiny_nusc_set(root, seed=4)


ULP_DRAW = 9   # seed of the rounding-sized weight move
GRAD_RMS = 1e-2     # a gradient tensor against the reference, relative RMS
OUT_RMS = 1e-4      # the same for the task heads' output convs
# the same for the DCN branches' offset convs: their gradient is the
# derivative of the bilinear weights, which jumps where a sample crosses a
# pixel edge, so a sample within rounding of an edge takes the other
# side's slope in one package (measured up to 1.006e-2)
OFFSET_RMS = 5e-2
# a clipped gradient this far from 0 fixes Adam's first step (eps 1e-8) to
# 2e-6 where the two packages' gradients agree to 1%: the batch's gradient
# norm (~3,000) is clipped to 35, so the regression heads' clipped
# gradients lie mostly under the Waymo step test's 1e-6
ADAM_CLEAR = 1e-7


def four_ulp(v, rng):
    """The variables with every parameter moved by four float32 ulps of
    relative size (x (1 +- 2^-21), the sign drawn per element): a move
    that shifts the JAX train-mode head maps as far as the port's rounding
    does (6.9e-6 against 6.2e-6 relative RMS on the 01voxel config; one
    ulp shifts them 3.2e-6)."""
    eps = np.float32(2.0 ** -21)
    move = lambda a: (np.asarray(a) * (1 + eps * rng.choice(
        np.float32([-1, 1]), np.shape(a)))).astype(np.float32)
    return {"params": jax.tree_util.tree_map(move, v["params"]),
            "batch_stats": v["batch_stats"]}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_jax(nusc_set, name):
    """One step of each package from the same weights and batch.

    At random weights the train-mode network amplifies rounding from the
    loss back to the stem, through every train-mode BatchNorm: the port
    (another summation order in every conv) lies 1e-6 to 1e-5 (relative
    RMS) from the reference at the task heads' output convs, up to 5e-3 in
    the DCN branches, and 1e-3 to 4e-3 at the 3D trunk. The reference moves
    as far when its weights move by a rounding-sized step (:func:`four_ulp`,
    one draw, ``ULP_DRAW``); two compiles of the JAX step, the spread the
    Waymo rule compared against, agree to 5e-6 to 2e-5 here, so they do
    not show the amplification, and the test asserts that the
    rounding-sized step does.
    So: the loss terms at rtol 1e-5; the gradient norm, which the backbone
    dominates, within 1e-5 or 3x its spread under that step; each gradient
    within ``GRAD_RMS`` (``OUT_RMS`` at the output convs, ``OFFSET_RMS``
    at the DCN offset convs); the DCN heads' conv biases ahead of a
    train-mode BatchNorm, whose gradient is zero up to rounding, under
    1e-5 of the largest gradient on both sides; the
    parameters after the step within 2 lr of the start, and at 2e-6 where
    Adam's first step is determined (the gradients agree to 1% and stand
    clear of its eps, ``ADAM_CLEAR``; at least half the elements), at most
    1% of the elements with gradients of opposite sign."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    root, info = nusc_set
    m, tc = tiny_centerpoint_cfg(CONFIGS[name])
    det = build_detector(m, None, tc, device="cpu")
    batch = nusc_batch(CONFIGS[name], m, info, root, "train", 2, seed=6)
    ex = {k: batch[k] for k in det.loss_keys}
    assert len(ex["hm"]) == 6 and sum(int(k.sum()) for k in ex["mask"]) > 5
    jdet = jax_build(m, None, tc)
    # flax's kernels: the bounds below were measured at them (at kernels
    # drawn N(0, 1 / fan_in) the port's deviation exceeds GRAD_RMS and
    # OUT_RMS at a few tensors, within the reference's own spread under
    # the rounding-sized step)
    v = nusc_jax_variables(jdet, np.random.RandomState(2), flax_init=True)
    lr_max, total = 3e-3, 1000
    tx = jax_opt(lr_max=lr_max, total_steps=total)
    jstep = jax.jit(lambda s, e: jax_step(jdet, tx)(s, e,
                                                   jax.random.PRNGKey(1)))
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    new_state, jmet = jstep(create_train_state(v, tx), jex)
    moved_state, moved_met = jstep(create_train_state(
        four_ulp(v, np.random.RandomState(ULP_DRAW)), tx), jex)

    load_converted(det.module, v)
    opt = build_one_cycle_optimizer(det.module, lr_max, total)
    met = make_train_step(det, opt)(
        {k: [torch.from_numpy(a) for a in x] if isinstance(x, list)
         else torch.from_numpy(x) for k, x in ex.items()},
        torch.Generator().manual_seed(0))

    assert sorted(met) == sorted(jmet)
    for k in ("det_loss", "hm_loss", "loc_loss"):
        assert len(met[k]) == len(jmet[k]) == 6
        np.testing.assert_allclose([float(x) for x in met[k]],
                                   [float(x) for x in jmet[k]], rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    norm, jnorm = float(met["grad_norm"]), float(jmet["grad_norm"])
    norm_spread = abs(float(moved_met["grad_norm"]) - jnorm) / jnorm
    assert abs(norm - jnorm) / jnorm <= max(1e-5, 3 * norm_spread), (
        norm, jnorm, norm_spread)

    b1 = np.float32(0.95)

    def jax_grads(state):
        return flax_to_torch({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) / (np.float32(1) - b1),
            state.opt_state.inner_state[1].mu)})

    want = jax_grads(new_state)
    other = jax_grads(moved_state)
    def rel(a, b):
        """Relative RMS of a against b; 0 where both are all zero (the
        regression heads of a task with no positive in the batch)."""
        nb = float(np.linalg.norm(b))
        return float(np.linalg.norm(a - b)) / nb if nb else float(
            np.abs(a).max() > 0)

    scale = min(1.0, 35.0 / norm)
    params = dict(det.module.named_parameters())
    assert sorted(want) == sorted(params)
    assert any("deform_kernel" in k for k in params) == (name != "01voxel")
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    spreads = {}
    for pname, p in params.items():
        assert p.grad is not None, pname
        g, r = p.grad.numpy() * scale, want[pname].numpy()
        spreads[pname] = rel(other[pname].numpy(), r)
        if pname.endswith("Conv_0.bias") and ".task" in pname:
            # ahead of BatchNorm_0 in train mode: no gradient but rounding
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-5 * gmax
            continue
        bound = (OUT_RMS if "_out." in pname else
                 OFFSET_RMS if ".conv_offset." in pname else GRAD_RMS)
        assert rel(g, r) <= bound, (pname, rel(g, r), spreads[pname])
    # the rounding-sized step moves the trunk's gradients by 1e-3 or more
    assert max(v for k, v in spreads.items()
               if k.startswith("backbone.")) > 1e-3

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
        # Adam's first step is determined where the two gradients agree
        # (to 1%) and stand clear of its eps (1e-8): there the parameters
        # are held at 2e-6; elsewhere each element's gradient differs by
        # the amplified rounding above, and only the sign flips are
        # counted
        clear = np.abs(gr) > ADAM_CLEAR
        firm = clear & (np.abs(g - gr) <= 1e-2 * np.abs(gr))
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_loose += int((clear & (np.sign(g) != np.sign(gr))).sum())
        n_firm += int(firm.sum())
        n_all += firm.size
    assert n_loose <= 0.01 * n_all and n_firm >= 0.5 * n_all, (
        n_loose, n_firm, n_all)
