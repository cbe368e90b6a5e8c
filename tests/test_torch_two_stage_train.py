"""The two-stage CenterPoint's train steps in partner_tpu_torch against
the JAX package (CPU, float32).

On the tiny cut of ``tests/test_torch_two_stage.py``: one step with
``freeze=False`` against ``jax.jit`` of JAX's ``make_train_step``, and the
frozen step against JAX's ``loss(..., train=False)`` with ``freeze=True``,
which runs the first stage on running statistics under ``stop_gradient``:
the freeze the port implements (ROADMAP.md §3).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_two_stage import ROOT, _pair, t
from torch_port_fixtures import TWO_STAGE

torch.set_num_threads(2)


def _step_example(rng, m, batch=2):
    """A tiny train batch with center targets and ``global_box`` (10
    columns, the velocity in), made by ``chip_smoke`` without JAX."""
    import chip_smoke

    from partner_tpu_torch.utils.config import load_config

    sys.path.insert(0, ROOT)
    train_cfg = load_config(os.path.join(ROOT, TWO_STAGE))["train_cfg"]
    return chip_smoke.centerpoint_train_example(
        rng, m["first_stage_cfg"], train_cfg, batch, 1500, 1800, 12)


def _plant_positives(jdet, v, ex, train, n=6):
    """Random weights propose boxes that overlap no synthetic gt: make the
    first ``n`` gt rows of each sample jittered copies of the proposals
    JAX's loss will rank first (the first stage in the same mode), so
    that the RoI regression loss has positives."""
    from partner_tpu.models.center_head import center_head_decode

    out, _ = jax.jit(lambda v, e: jdet.module.apply(
        v, e, train=train, mutable=["batch_stats"] if train else []))(
        v, {k: ex[k] for k in ("points", "points_mask")})
    task = out[0]["det_preds"][0]
    fd, first = jdet.first_driver, jdet.module.first
    boxes, scores = center_head_decode(
        task, task["hm"].shape[1:3], fd.voxel_size, first.pc_range,
        first.out_size_factor, voxel_shape=fd.voxel_shape)
    top = np.argsort(-np.asarray(scores).max(-1), axis=1, kind="stable")
    rng = np.random.RandomState(5)
    for b in range(len(top)):
        props = np.asarray(boxes)[b, top[b, : 3 * n: 3]]
        gt = ex["global_box"][b, :n]
        gt[:, :6], gt[:, 8] = props[:, :6], props[:, -1]
        gt[:, :2] += rng.uniform(-0.05, 0.05, (n, 2)) * props[:, 3:5]
        gt[:, 9] = 1
    ex["global_box_mask"] = ex["global_box"][..., -1] > 0
    return ex


def _torch_example(ex):
    return {k: [t(a) for a in x] if isinstance(x, list) else t(x)
            for k, x in ex.items()}


def _jax_grads(state):
    """The JAX step's own gradients, read back from Adam's first moment
    after one step (mu = (1 - b1) g), as the port's names."""
    from partner_tpu_torch.convert import flax_to_torch

    b1 = np.float32(0.95)
    return flax_to_torch({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) / (np.float32(1) - b1),
        state.opt_state.inner_state[1].mu)})


def test_train_step_matches_jax(rng):
    """One float32 step of the tiny one-sweep config with ``freeze=False``
    at b = 2 against ``jax.jit(make_train_step)`` from the same converted
    weights: every loss term (the first stage's per-task lists,
    ``roi_cls_loss``, ``roi_reg_loss``) and the gradient norm within
    1e-5; the gradients and updated parameters of the RoI head, the neck
    and the center head by the rules of the CenterPoint step
    (``tests/test_torch_centerpoint.py``), and the 3D trunk's gradients
    within 3x the JAX step's own spread.

    That spread is taken here by scaling every weight by 1 + 1e-6: the
    scatter-max then picks another winner in a few near-tied cells, as the
    port's rounding does, and the trunk's gradients move by 0.06-0.2%
    (measured; the port lies 0.03-0.4% from the reference, at most 2.9x
    its spread). The CenterPoint test's measure, a traced against a
    constant compile, moved them by 2e-6 on this batch and so says
    nothing here."""
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    jdet, v, tdet, m, _ = _pair(freeze=False, seed=1)
    ex = _plant_positives(jdet, v, _step_example(rng, m), train=True)
    assert ex["global_box_mask"].sum() >= 12
    lr_max, total = 3e-3, 1000
    tx = jax_opt(lr_max=lr_max, total_steps=total)
    step = jax_step(jdet, tx)
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    key = jax.random.PRNGKey(1)
    jstep = jax.jit(lambda s: step(s, jex, key))
    new_state, jmet = jstep(create_train_state(v, tx))
    scaled = {"params": jax.tree_util.tree_map(
        lambda a: a * np.float32(1 + 1e-6), v["params"]),
        "batch_stats": v["batch_stats"]}
    nudged, _ = jstep(create_train_state(scaled, tx))

    opt = build_one_cycle_optimizer(tdet.module, lr_max, total)
    assert len(opt.params) == len(list(tdet.module.parameters()))
    met = make_train_step(tdet, opt)(_torch_example(ex),
                                     torch.Generator().manual_seed(0))
    assert sorted(met) == sorted(jmet)
    assert {"roi_cls_loss", "roi_reg_loss", "det_loss"} <= set(met)
    for k in ("det_loss", "hm_loss", "loc_loss"):
        assert len(met[k]) == len(jmet[k]) == 1
        np.testing.assert_allclose(float(met[k][0]), float(jmet[k][0]),
                                   rtol=1e-5, err_msg=k)
    for k in ("roi_cls_loss", "roi_reg_loss", "loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(met["roi_reg_loss"]) > 0     # the planted positives

    want, other = _jax_grads(new_state), _jax_grads(nudged)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    scale = min(1.0, 35.0 / float(met["grad_norm"]))
    params = dict(tdet.module.named_parameters())
    assert sorted(want) == sorted(params)
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in params.items():
        assert p.grad is not None, name
        g, r = p.grad.numpy() * scale, want[name].numpy()
        if name.startswith("first.backbone."):
            spread = rel(other[name].numpy(), r)
            assert rel(g, r) <= 3 * spread + 1e-5, (name, rel(g, r), spread)
            continue
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-5 * gmax,
                                   err_msg=name)

    lr0 = lr_max / 10.0
    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    sd = tdet.module.state_dict()
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
        firm = (np.sign(g) == np.sign(gr)) & (np.abs(gr) > 1e-6)
        if k.startswith("first.backbone."):
            firm &= np.isclose(got, r, rtol=1e-6, atol=2e-6)
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_loose += int((~firm).sum())
        n_all += firm.size
    assert n_loose <= 0.01 * n_all


def test_frozen_step_matches_jax_loss(rng):
    """The frozen step (``freeze=True``): the port's first stage runs in
    eval mode without autograd; JAX's ``loss(..., train=False)`` with
    ``freeze=True`` runs it on running statistics under ``stop_gradient``,
    the same function. The BEV map, the RoI losses and the RoI head's
    gradients against JAX's; the optimizer holds the RoI head alone, the
    first stage's parameters and statistics are bit-unchanged after the
    step and every RoI parameter moved."""
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    jdet, v, tdet, m, _ = _pair(freeze=True, seed=2)
    assert tdet.freeze and tdet.loss_keys == (
        "points", "points_mask", "global_box", "global_box_mask")
    ex = _plant_positives(jdet, v, _step_example(rng, m), train=False)
    jex = jax.tree_util.tree_map(jnp.asarray, ex)

    def loss_fn(params):
        ld, _ = jdet.loss({"params": params,
                           "batch_stats": v["batch_stats"]}, jex,
                          train=False)
        return ld["loss"], ld

    (_, jld), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    _, jbev = jax.jit(lambda v, e: jdet.module.apply(v, e, train=False))(
        v, {k: jex[k] for k in ("points", "points_mask")})
    jg = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                         jgrads)})
    assert all(not np.any(jg[k].numpy()) for k in jg
               if k.startswith("first."))

    before = {k: x.clone() for k, x in tdet.module.state_dict().items()}
    opt = build_one_cycle_optimizer(tdet.module, 3e-3, 1000)
    roi = [n for n, _ in tdet.module.named_parameters()
           if n.startswith("roi_head.")]
    assert len(opt.params) == len(roi) == 12
    tex = _torch_example({k: ex[k] for k in tdet.loss_keys})
    with torch.no_grad():
        _, bev = tdet.module(tex)
    np.testing.assert_allclose(bev.numpy(), np.asarray(jbev), rtol=1e-5,
                               atol=1e-5)
    met = make_train_step(tdet, opt)(tex, torch.Generator().manual_seed(0))
    assert sorted(met) == ["grad_norm", "loss", "roi_cls_loss",
                           "roi_reg_loss"]
    assert not tdet.module.first.training and tdet.module.roi_head.training
    for k in ("roi_cls_loss", "roi_reg_loss", "loss"):
        np.testing.assert_allclose(float(met[k]), float(jld[k]), rtol=1e-5,
                                   err_msg=k)
    gmax = max(float(np.abs(jg[n].numpy()).max()) for n in roi)
    for n, p in tdet.module.named_parameters():
        if n.startswith("first."):
            assert p.grad is None and not p.requires_grad, n
            continue
        np.testing.assert_allclose(p.grad.numpy(), jg[n].numpy(), rtol=1e-3,
                                   atol=1e-5 * gmax, err_msg=n)
    after = tdet.module.state_dict()
    for k, x in before.items():
        if k.startswith("first."):
            assert torch.equal(after[k], x), k
        else:
            assert not torch.equal(after[k], x), k

