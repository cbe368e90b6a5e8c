"""partner_tpu_torch's IoU-regression losses (``losses/iou_losses.py``)
and the SetCriterion's ``loss_iou_reg`` term against the JAX package's
(CPU, f32): each function's value and gradient on aligned box pairs that
overlap (rotated, shifted, identical), touch (a shared face) and lie
apart, and the criterion's term with its gradient by the predictions.

Bounds: float32 rounding. The values within 1e-5 (1 + |ref|) (the
rotated overlap's clipping arithmetic in another order; ``tests/
test_torch_losses.py`` holds ``boxes_iou3d`` itself at 1e-5) at every
pair; the gradients within 1e-4 relative and 1e-5 of the largest at
every pair where the function is differentiable. At the identical pair
(coincident edges in the clipped polygon) and the touching pairs (the
overlap's kink at 0) the two frameworks take different one-sided
derivatives (JAX's corner loss a NaN: the norm of a zero vector); there
the port's gradients are held finite only (``KINKS``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_losses import (FLAGSHIP_CRIT, MATCHER_WEIGHTS,
                               _criterion_case)

torch.set_num_threads(2)

FUNCS = ("bbox3d_overlaps_iou", "bbox3d_overlaps_giou",
         "bbox3d_overlaps_diou", "corner_loss_lidar")
KINKS = [2, 3, 4]   # _pairs' identical pair and its two touching pairs


def _pairs(rng):
    """(N, 7) pairs: overlapping (rotated, shifted), identical, touching
    (a shared x face, a shared z face) and apart, then random overlaps."""
    a = [[3, 3, 1, 4, 4, 2, 0.0], [3, 3, 1, 2, 2, 2, 0.0],
         [10, 5, 0, 4, 2, 1.5, 0.3], [1, 1, 0, 2, 2, 2, 0.0],
         [1, 1, 0, 2, 2, 2, 0.0], [0, 0, 0, 4, 2, 1.5, 0.0],
         [-20, 40, 0.5, 4.5, 1.9, 1.6, -2.9]]
    b = [[3.2, 3, 1.5, 4, 4, 2, np.pi / 4], [3.5, 3, 1, 2, 2, 2, np.pi / 3],
         [10, 5, 0, 4, 2, 1.5, 0.3], [3, 1, 0, 2, 2, 2, 0.0],
         [1, 1, 2, 2, 2, 2, 0.0], [30, 0, 0, 4, 2, 1.5, 1.0],
         [-19.5, 40.2, 0.3, 4.2, 2.0, 1.5, 0.2]]
    n = 24
    ra = np.concatenate([rng.uniform(-5, 5, (n, 3)),
                         rng.uniform(0.5, 5, (n, 3)),
                         rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    rb = ra + np.concatenate([rng.normal(0, 1, (n, 3)),
                              rng.normal(0, 0.5, (n, 3)).clip(-0.4, 0.4),
                              rng.normal(0, 0.8, (n, 1))], 1)
    return (np.concatenate([a, ra]).astype(np.float32),
            np.concatenate([b, rb]).astype(np.float32))


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()),
                               err_msg=what)


KINDS = ("IoU", "GIoU", "DIoU")


@pytest.fixture(scope="module")
def case():
    """The pairs, a mask, JAX's values and gradients of every function
    (one compile, one backward: each function on its own copy of the
    pairs) and JAX's ``iou_reg_loss`` of each kind."""
    from partner_tpu.losses import iou_losses as jl

    rng = np.random.RandomState(0)
    a, b = _pairs(rng)
    mask = rng.rand(len(a)) < 0.7
    mask[KINKS] = False

    def total(xs, ys):
        vals = {n: getattr(jl, n)(xs[i], ys[i]) for i, n in enumerate(FUNCS)}
        return sum(jnp.sum(v) for v in vals.values()), vals

    stack = lambda x: np.stack([x] * len(FUNCS))
    (ga, gb), vals = jax.jit(jax.grad(total, argnums=(0, 1),
                                      has_aux=True))(stack(a), stack(b))
    grads = {n: (ga[i], gb[i]) for i, n in enumerate(FUNCS)}
    regs = jax.jit(lambda x, y, m: {k: jl.iou_reg_loss(x, y, k, mask=m)
                                    for k in KINDS})(a, b, mask)
    return a, b, mask, grads, vals, regs


@pytest.mark.parametrize("name", FUNCS)
def test_iou_functions_and_gradients_match_jax(case, name):
    """Each overlap (and the corner loss) and its gradient by both boxes
    against JAX's; the first pairs' values as their geometry says: an
    overlap inside (0, 1), identical boxes 1, a touching pair's and an
    apart pair's IoU 0 (GIoU and DIoU below it)."""
    from partner_tpu_torch.losses import iou_losses

    a, b, _, grads, vals, _ = case
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    val = getattr(iou_losses, name)(ta, tb)
    val.sum().backward()
    _close(val.detach().numpy(), vals[name], name)
    smooth = np.setdiff1d(np.arange(len(a)), KINKS)
    for got, r, side in ((ta.grad, grads[name][0], "a"),
                         (tb.grad, grads[name][1], "b")):
        got, r = got.numpy(), np.asarray(r)
        assert np.isfinite(got).all()
        got, r = got[smooth], r[smooth]
        np.testing.assert_allclose(got, r, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(r).max()),
                                   err_msg=(name, side))
    v = val.detach().numpy()
    if name == "bbox3d_overlaps_iou":
        assert 0 < v[0] < 1 and 0 < v[1] < 1
        assert v[2] == pytest.approx(1.0, abs=1e-6)
        assert v[3] == v[4] == v[5] == 0.0
    elif name != "corner_loss_lidar":
        assert v[2] == pytest.approx(1.0, abs=1e-6)
        assert v[5] < 0 and v[3] <= 0


@pytest.mark.parametrize("kind", KINDS)
def test_iou_reg_loss_matches_jax(case, kind):
    """``iou_reg_loss`` (``1 - overlap`` summed over the masked pairs, the
    kinks masked out) against JAX's, and its gradient by the predicted
    boxes against ``-mask`` times JAX's gradient of the overlap (the loss
    is elementwise)."""
    from partner_tpu_torch.losses import iou_losses

    a, b, mask, grads, _, regs = case
    ta = torch.from_numpy(a).requires_grad_()
    got = iou_losses.iou_reg_loss(ta, torch.from_numpy(b), kind,
                                  mask=torch.from_numpy(mask))
    got.backward()
    _close(got.item(), float(regs[kind]), kind)
    r = -mask.astype(np.float32)[:, None] * np.asarray(
        grads[f"bbox3d_overlaps_{kind.lower()}"][0])
    np.testing.assert_allclose(ta.grad.numpy(), r, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(r).max()))


def test_set_criterion_iou_reg_term_matches_jax(rng):
    """The SetCriterion with ``loss_iou_reg`` among its losses (weight 2):
    every term as JAX's, and the gradients of ``loss`` by the
    predictions."""
    from partner_tpu.core.center_coder import CenterCoder as JCoder
    from partner_tpu.losses.set_crit import SetCriterion as JCrit
    from partner_tpu_torch.core.center_coder import CenterCoder
    from partner_tpu_torch.losses.set_crit import SetCriterion

    crit = dict(FLAGSHIP_CRIT,
                weight_dict=dict(FLAGSHIP_CRIT["weight_dict"],
                                 loss_iou_reg=2),
                losses=FLAGSHIP_CRIT["losses"] + ["loss_iou_reg"])
    preds, gt, classes, gt_mask, votemap = _criterion_case(rng)
    jcrit = JCrit(JCoder(), matcher_weights=MATCHER_WEIGHTS, **crit)
    tcrit = SetCriterion(CenterCoder(), matcher_weights=MATCHER_WEIGHTS,
                         **crit)

    def jloss(p, *targets):
        out = jcrit(p, *targets)
        return out["loss"], out

    jgrads, ref = jax.jit(jax.grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()}, gt, classes, gt_mask,
        votemap)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    out = tcrit(tp, *(torch.from_numpy(np.asarray(x))
                      for x in (gt, classes, gt_mask, votemap)))
    out["loss"].backward()
    assert sorted(out) == sorted(ref)
    assert float(ref["loss_iou_reg"]) > 0
    for k in crit["losses"] + ["loss"]:
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]),
                                   rtol=1e-5, err_msg=k)
    for k, t in tp.items():
        r = np.asarray(jgrads[k])
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(r).max()),
                                   err_msg=k)
