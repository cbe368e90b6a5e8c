"""The set losses of partner_tpu_torch against the JAX package (CPU, f32):
the element losses, the Sutherland-Hodgman 3D IoU of ``loss_iou``'s
target, the CenterCoder's encode, the SetCriterion term by term with its
gradients, and the numpy vote-map target."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

FLAGSHIP_CRIT = {
    "weight_dict": {"loss_ce": 1, "loss_bbox": 2, "loss_vote": 0.25,
                    "loss_vote_cls": 1, "loss_iou": 2},
    "losses": ["loss_ce", "loss_bbox", "loss_vote", "loss_vote_cls",
               "loss_iou"],
    "sigma": 3.0, "code_weights": [1.0] * 8, "gamma": 2.0, "alpha": 0.25}
MATCHER_WEIGHTS = {"loss_ce": 0.25, "loss_bbox": 0.75}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_focal_and_smooth_l1_match_jax(rng):
    from partner_tpu.losses import centernet as jc
    from partner_tpu_torch.losses import centernet

    logits = (rng.randn(3, 50, 2) * 6).astype(np.float32)  # saturated too
    target = (rng.rand(3, 50, 2) < 0.3).astype(np.float32)
    target[0] = rng.rand(50, 2)                            # soft targets
    for gamma, alpha in ((2.0, 0.25), (1.5, 0.5)):
        ref = float(jc.sigmoid_focal_loss(logits, target, gamma, alpha))
        got = float(centernet.sigmoid_focal_loss(_t(logits), _t(target),
                                                 gamma, alpha))
        # a 300-term f32 sum in another order
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    x = np.concatenate([rng.randn(200) * 0.2, [1 / 9, -1 / 9, 0.0]])
    x = x.astype(np.float32)
    for sigma in (3.0, 1.0):
        np.testing.assert_allclose(
            centernet.smooth_l1(_t(x), sigma).numpy(),
            np.asarray(jc.smooth_l1(x, sigma)), rtol=1e-6, atol=1e-7)


def _iou_cases(rng):
    """(N, 7) box pairs [x, y, z, dx, dy, dz, yaw]: identical, disjoint,
    rotated overlaps, touching, degenerate (zero-width) and random."""
    a = [[10, 5, 0, 4, 2, 1.5, 0.3], [0, 0, 0, 4, 2, 1.5, 0.0],
         [3, 3, 1, 4, 4, 2, 0.0], [3, 3, 1, 2, 2, 2, 0.0],
         [1, 1, 0, 2, 2, 2, 0.0], [5, 5, 0, 3, 0, 2, 0.4],
         [-20, 40, 0.5, 4.5, 1.9, 1.6, -2.9]]
    b = [[10, 5, 0, 4, 2, 1.5, 0.3], [30, 0, 0, 4, 2, 1.5, 1.0],
         [3, 3, 1.5, 4, 4, 2, np.pi / 4], [3.5, 3, 1, 2, 2, 2, np.pi / 3],
         [3, 1, 0, 2, 2, 2, 0.0], [5, 5, 0, 3, 1, 2, 0.4],
         [-19.5, 40.2, 0.3, 4.2, 2.0, 1.5, 0.2]]
    n = 64
    ra = np.concatenate([rng.uniform(-5, 5, (n, 3)),
                         rng.uniform(0.5, 5, (n, 3)),
                         rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    rb = ra + np.concatenate([rng.normal(0, 1, (n, 3)),
                              rng.normal(0, 0.5, (n, 3)).clip(-0.4, 0.4),
                              rng.normal(0, 0.8, (n, 1))], 1)
    return (np.concatenate([a, ra]).astype(np.float32),
            np.concatenate([b, rb]).astype(np.float32))


def test_boxes_iou3d_matches_jax(rng):
    from partner_tpu.ops import rotated_iou as jr
    from partner_tpu_torch.ops import rotated_iou

    a, b = _iou_cases(rng)
    ref = np.asarray(jr.boxes_iou3d(a, b))
    got = rotated_iou.boxes_iou3d(_t(a), _t(b)).numpy()
    # the same clipping arithmetic in f32; corners rotate by cos/sin
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:2], [1.0, 0.0], atol=1e-6)
    assert got[5] == 0.0                       # a zero-width box
    assert 0.0 < got[2] < 1.0 and 0.0 < got[3] < 1.0
    bev = [0, 1, 3, 4, 6]
    np.testing.assert_allclose(
        rotated_iou.rect_intersection_area_sh(_t(a[:, bev]),
                                              _t(b[:, bev])).numpy(),
        np.asarray(jr.rect_intersection_area_sh(a[:, bev], b[:, bev])),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sincos", [True, False], ids=["sincos", "angle"])
@pytest.mark.parametrize("rectify", [False, True],
                         ids=["plain", "rectify"])
def test_center_coder_encode_and_delta_match_jax(rng, sincos, rectify):
    from partner_tpu.core.center_coder import CenterCoder as JCoder
    from partner_tpu_torch.core.center_coder import CenterCoder

    boxes = np.concatenate([rng.uniform(-70, 70, (40, 3)),
                            rng.uniform(0.0, 6, (40, 3)),
                            rng.uniform(-np.pi, np.pi, (40, 1))], 1)
    boxes[:3, 3:6] = 0.0                       # dims clamped before the log
    boxes = boxes.astype(np.float32)
    kw = dict(code_size=7, encode_angle_by_sincos=sincos, rectify=rectify)
    jc, tc = JCoder(**kw), CenterCoder(**kw)
    enc = tc.encode(_t(boxes)).numpy()
    # elementwise log / cos / sin / atan2 in f32
    np.testing.assert_allclose(enc, np.asarray(jc.encode(boxes)), rtol=1e-5,
                               atol=1e-5)
    preds = rng.randn(40, tc.code_size).astype(np.float32)
    np.testing.assert_allclose(
        tc.get_delta(_t(boxes), _t(preds)).numpy(),
        np.asarray(jc.get_delta(boxes, preds)), rtol=1e-5, atol=1e-5)
    # decode inverts encode (dims above the clamp)
    np.testing.assert_allclose(tc.decode(_t(enc))[3:, :6].numpy(),
                               boxes[3:, :6], rtol=1e-4, atol=1e-4)


def _criterion_case(rng, b=2, n=96, m=6):
    """Predictions with a few queries near their gts (so that the matches
    and the IoU target are real), padded gts with masked slots, and a vote
    map with empty cells."""
    from partner_tpu_torch.core.center_coder import CenterCoder

    gt = np.concatenate([rng.uniform(-30, 30, (b, m, 2)),
                         rng.uniform(-1, 1, (b, m, 1)),
                         rng.uniform(1.5, 5, (b, m, 3)),
                         rng.uniform(-np.pi, np.pi, (b, m, 1))], -1)
    gt = gt.astype(np.float32)
    gt_mask = rng.rand(b, m) < 0.8
    gt_mask[:, 0] = True
    enc = CenterCoder().encode(_t(gt)).numpy()
    boxes = rng.randn(b, n, 8).astype(np.float32) * 3
    for i in range(b):
        near = rng.choice(n, m, replace=False)
        boxes[i, near] = enc[i] + rng.randn(m, 8).astype(np.float32) * 0.2
    preds = {"pred_logits": rng.randn(b, n, 1).astype(np.float32),
             "pred_boxes": boxes,
             "pred_centers": rng.randn(b, n, 2).astype(np.float32) * 20,
             "pred_vote_cls": rng.randn(b, n, 1).astype(np.float32),
             "pred_ious": rng.randn(b, n, 1).astype(np.float32) * 0.5}
    votemap = np.zeros((b, n, 5), np.float32)
    on = rng.rand(b, n) < 0.3
    votemap[on] = rng.randn(int(on.sum()), 5) * 10
    votemap[..., 4] = np.where(on, rng.rand(b, n), 0.0)
    classes = np.zeros((b, m), np.int32)
    return preds, gt, classes, gt_mask, votemap


def test_set_criterion_terms_and_gradients_match_jax(rng):
    from partner_tpu.core.center_coder import CenterCoder as JCoder
    from partner_tpu.losses.set_crit import SetCriterion as JCrit
    from partner_tpu_torch.core.center_coder import CenterCoder
    from partner_tpu_torch.losses.set_crit import SetCriterion

    preds, gt, classes, gt_mask, votemap = _criterion_case(rng)
    jcrit = JCrit(JCoder(), matcher_weights=MATCHER_WEIGHTS,
                  **FLAGSHIP_CRIT)
    tcrit = SetCriterion(CenterCoder(), matcher_weights=MATCHER_WEIGHTS,
                         **FLAGSHIP_CRIT)

    def jloss(p):
        out = jcrit(p, gt, classes, gt_mask, votemap)
        return out["loss"], out

    jgrads, ref = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: _t(v).requires_grad_() for k, v in preds.items()}
    out = tcrit(tp, _t(gt), _t(classes), _t(gt_mask), _t(votemap))
    out["loss"].backward()
    assert sorted(out) == sorted(ref)
    assert int(out["num_matched"]) == int(ref["num_matched"]) == \
        int(gt_mask.sum())
    assert float(ref["loss_iou"]) > 0 and float(ref["loss_bbox"]) > 0
    for k in FLAGSHIP_CRIT["losses"] + ["loss"]:
        # sums of a few hundred f32 terms in another order
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    for k, t in tp.items():
        r = np.asarray(jgrads[k])
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(r).max()),
                                   err_msg=k)


def test_set_criterion_without_valid_gts(rng):
    """All gts masked: nothing matched, ``num_boxes`` floored at 1, the
    box and IoU terms 0, finite gradients."""
    from partner_tpu.core.center_coder import CenterCoder as JCoder
    from partner_tpu.losses.set_crit import SetCriterion as JCrit
    from partner_tpu_torch.core.center_coder import CenterCoder
    from partner_tpu_torch.losses.set_crit import SetCriterion

    preds, gt, classes, gt_mask, votemap = _criterion_case(rng)
    gt_mask[:] = False
    ref = JCrit(JCoder(), matcher_weights=MATCHER_WEIGHTS, **FLAGSHIP_CRIT)(
        preds, gt, classes, gt_mask, votemap)
    tp = {k: _t(v).requires_grad_() for k, v in preds.items()}
    out = SetCriterion(CenterCoder(), matcher_weights=MATCHER_WEIGHTS,
                       **FLAGSHIP_CRIT)(tp, _t(gt), _t(classes),
                                        _t(gt_mask), _t(votemap))
    out["loss"].backward()
    assert int(out["num_matched"]) == int(ref["num_matched"]) == 0
    assert float(out["loss_bbox"].detach()) == 0.0
    assert float(out["loss_iou"].detach()) == 0.0
    for k in FLAGSHIP_CRIT["losses"] + ["loss"]:
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    assert all(torch.isfinite(t.grad).all() for t in tp.values())


def test_draw_votemap_equals_jax(rng):
    """The port's numpy copy of ``draw_votemap`` against the JAX package's
    on scenes with boxes near the origin (azimuth truncation), at the
    range's edge and out of range, on the flagship grid."""
    from partner_tpu.core import targets as jt
    from partner_tpu_torch.core import targets

    grid = (1152, 2048, 40)
    pr = (0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0)
    vs = [(pr[3 + i] - pr[i]) / grid[i] for i in range(3)]
    for scene in range(4):
        n = 12
        rho = rng.uniform(0.5, 80, n)
        rho[:2] = rng.uniform(0.5, 3.0, 2)          # wrap-around boxes
        phi = rng.uniform(-np.pi, np.pi, n)
        boxes = np.stack([rho * np.cos(phi), rho * np.sin(phi),
                          rng.uniform(-1, 1, n), rng.uniform(1.5, 6, n),
                          rng.uniform(1.5, 3, n), rng.uniform(1.4, 2, n),
                          rng.uniform(-np.pi, np.pi, n)], 1)
        boxes = boxes.astype(np.float32)
        classes = rng.randint(0, 2, n)
        ref = jt.draw_votemap(boxes, classes, 2, grid, vs, pr, 8)
        got = targets.draw_votemap(boxes, classes, 2, grid, vs, pr, 8)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert (got[..., 4:] > 0).any()
