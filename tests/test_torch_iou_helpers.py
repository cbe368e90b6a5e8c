"""The port's exact polygon BEV IoU, circle NMS, tensor geometry helpers,
``ClosureHook`` and ``ConvBNReLU`` against the JAX package's, on inputs
made with numpy from a seed. Float32 on both sides."""

import numpy as np
import pytest
import torch

IOU_TOL = 1e-5   # absolute, IoU in [0, 1]: float32 in two summation orders
GEOM_TOL = dict(rtol=1e-6, atol=1e-5)   # metres, float32


def _rects(rng, n, spread=4.0):
    """(n, 5) float32 rects [x, y, dx, dy, yaw] packed near the origin,
    so that most pairs overlap."""
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)),
        rng.uniform(0.5, 4.0, (n, 2)),
        rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


# pairs whose polygon has coincident or collinear candidates
DEGENERATE = {
    "identical": ([1.0, 2.0, 4.0, 2.0, 0.3], [1.0, 2.0, 4.0, 2.0, 0.3]),
    "touching edge": ([0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 0.0, 2.0, 2.0, 0.0]),
    "touching corner": ([0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 2.0, 2.0, 2.0, 0.0]),
    "nested": ([0.0, 0.0, 4.0, 4.0, 0.5], [0.2, -0.1, 1.0, 1.5, 0.5]),
    "nested rotated": ([0.0, 0.0, 6.0, 6.0, 0.0], [0.5, 0.5, 1.0, 2.0, 1.1]),
    "parallel overlap": ([0.0, 0.0, 4.0, 2.0, 0.7], [1.0, 0.0, 4.0, 2.0, 0.7]),
    "shared edge line": ([0.0, 0.0, 4.0, 2.0, 0.0], [1.0, 1.0, 4.0, 2.0, 0.0]),
    "quarter turn": ([0.0, 0.0, 4.0, 2.0, 0.0], [0.0, 0.0, 4.0, 2.0,
                                                   np.pi / 2]),
    "apart": ([0.0, 0.0, 1.0, 1.0, 0.0], [5.0, 5.0, 1.0, 1.0, 0.2]),
}


@pytest.fixture(scope="module")
def jr():
    """The JAX package's IoU entries, jitted (eagerly each op compiles on
    its own: ~10x slower)."""
    import types

    import jax

    from partner_tpu.ops import rotated_iou

    return types.SimpleNamespace(**{
        k: jax.jit(getattr(rotated_iou, k)) for k in (
            "boxes_iou_bev", "iou_bev_row", "rect_intersection_area")})


@pytest.fixture(scope="module")
def rects():
    rng = np.random.RandomState(11)
    return _rects(rng, 16), _rects(rng, 12)


def test_boxes_iou_bev_matches_jax_on_random_pairs(jr, rects):
    from partner_tpu_torch.ops.rotated_iou import boxes_iou_bev

    a, b = rects
    want = np.asarray(jr.boxes_iou_bev(a, b))
    got = boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (16, 12)
    assert (want > 0.05).sum() > 20     # the pairs do overlap
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_TOL)


def test_iou_bev_row_matches_jax_on_random_pairs(jr, rects):
    from partner_tpu_torch.ops.rotated_iou import iou_bev_row

    a, b = rects
    for i in range(3):
        want = np.asarray(jr.iou_bev_row(a[i], b))
        got = iou_bev_row(torch.from_numpy(a[i]), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IOU_TOL)


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_degenerate_pairs_match_jax(jr, case):
    """Identical, touching, nested and parallel-edged pairs, both ways
    round, by both entries and by the intersection area itself."""
    from partner_tpu_torch.ops import rotated_iou as tr

    a, b = (np.asarray(x, np.float32) for x in DEGENERATE[case])
    pair = np.stack([a, b])
    want = np.asarray(jr.boxes_iou_bev(pair, pair))
    got = tr.boxes_iou_bev(torch.from_numpy(pair), torch.from_numpy(pair))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IOU_TOL)
    np.testing.assert_allclose(
        tr.iou_bev_row(torch.from_numpy(a), torch.from_numpy(pair)).numpy(),
        np.asarray(jr.iou_bev_row(a, pair)), rtol=0, atol=IOU_TOL)
    np.testing.assert_allclose(
        tr.rect_intersection_area(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy(),
        np.asarray(jr.rect_intersection_area(a, b)), rtol=0, atol=1e-5)
    if case == "identical":
        np.testing.assert_allclose(got.numpy(), 1.0, atol=IOU_TOL)


def test_circle_nms_keeps_jax_indices():
    """Clustered centers, scores with exact ties (broken toward the lower
    index), padding rows and non-finite scores; the squared distance is
    held against ``min_radius``."""
    from partner_tpu.ops.nms import NEG_INF
    from partner_tpu.ops.nms import circle_nms as jcircle
    from partner_tpu_torch.ops.nms import circle_nms

    rng = np.random.RandomState(3)
    n = 300
    centers = (rng.randint(0, 12, (n, 2)) * 1.5
               + rng.normal(0, 0.4, (n, 2))).astype(np.float32)
    scores = rng.randint(0, 40, n).astype(np.float32) / 40.0   # many ties
    scores[-20:] = NEG_INF
    scores[[3, 7]] = [np.nan, np.inf]
    for radius, post in ((0.85, 80), (4.0, 100), (12.0, 40)):
        jidx, jmask = jcircle(centers, scores, radius, post)
        idx, mask = circle_nms(torch.from_numpy(centers),
                               torch.from_numpy(scores), radius, post)
        assert idx.shape == (post,) and mask.shape == (post,)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert 0 < int(mask.sum()) < n - 20


def test_geometry_helpers_match_jax():
    from partner_tpu.core import geometry as jg
    from partner_tpu_torch.core import geometry as tg

    rng = np.random.RandomState(4)
    boxes = np.concatenate([rng.uniform(-70, 70, (32, 3)),
                            rng.uniform(0.3, 6, (32, 3)),
                            rng.uniform(-np.pi, np.pi, (32, 1))],
                           1).astype(np.float32)
    got = tg.boxes_to_corners_3d(torch.from_numpy(boxes))
    assert got.shape == (32, 8, 3)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jg.boxes_to_corners_3d(boxes)),
                               **GEOM_TOL)
    xy = boxes[:, :2]
    rho, phi = tg.cart_to_polar(torch.from_numpy(xy))
    jrho, jphi = jg.cart_to_polar(xy)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), **GEOM_TOL)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=0,
                               atol=1e-6)
    x, y = tg.polar_to_cart(rho, phi)
    jx, jy = jg.polar_to_cart(jrho, jphi)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **GEOM_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **GEOM_TOL)
    np.testing.assert_allclose(np.stack([x.numpy(), y.numpy()], 1), xy,
                               rtol=0, atol=1e-4)


def test_closure_hook_binds_its_stage_like_jax():
    from partner_tpu.train.hooks import ClosureHook as JHook
    from partner_tpu_torch.train.hooks import ClosureHook

    for cls in (JHook, ClosureHook):
        calls = []
        h = cls("after_iter", lambda t: calls.append(t))
        h.after_iter(42)
        assert calls == [42]
        assert not hasattr(h, "before_iter")
        with pytest.raises(AssertionError):
            cls("after_iter", "not callable")


@pytest.mark.parametrize("stride,use_bias", [(1, False), (2, True)])
def test_conv_bn_relu_matches_flax(stride, use_bias):
    """``ConvBNReLU`` with flax's weights carried across by
    ``convert.flax_to_torch``: eval mode (running statistics) and train
    mode (batch statistics and their running update)."""
    import jax

    from partner_tpu.models.layers import ConvBNReLU as JConvBNReLU
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models.layers import ConvBNReLU
    from torch_port_fixtures import drawn_init, jax_apply, randomize

    rng = np.random.RandomState(5 + stride)
    x = rng.normal(0, 1, (2, 9, 10, 6)).astype(np.float32)
    jm = JConvBNReLU(features=8, stride=stride, use_bias=use_bias)
    v = randomize(drawn_init(jm.init, rng, x, train=False), rng)
    m = ConvBNReLU(6, 8, stride=stride, use_bias=use_bias)
    m.load_state_dict(flax_to_torch(v), strict=True)
    tx = torch.from_numpy(x)

    m.eval()
    want = jax_apply(jm, v, x, train=False)
    with torch.no_grad():
        got = m(tx).numpy()
    assert got.shape == want.shape == (2, -(-9 // stride), -(-10 // stride),
                                       8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    m.train()
    want, upd = jax_apply(jm, v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = m(tx).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = flax_to_torch({"batch_stats": jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])})
    for k, t in stats.items():
        np.testing.assert_allclose(m.state_dict()[k].numpy(), t.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
