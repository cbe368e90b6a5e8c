"""The segmentation heads, the seg loss, the grid label helpers and the
seg metrics of partner_tpu_torch against the JAX package (CPU, float32).

``models/seg_head.py``: the bilinear resize at the heads' sizes (the
antialiased shrink of 506 -> 64 and 634 -> 80, the x4 growth), both
heads' logits from converted, randomized flax weights (``DeconvConvHead``
on a 4-D canvas at the cuboid and cylinder configs' deconv sizes, and on
the 5-D canvas no config reaches), each loss function with its gradients
against ``jax.grad`` (tied errors planted), the grid cells with points on
cell edges, the majority labels with planted ties, the point labels
with indices off the grid, ``panoptic_fuse``; ``eval/seg_metrics.py``
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_fixtures import drawn_init, load_converted, randomize

torch.set_num_threads(2)

# float32 both sides, another summation order
LOGIT_RMS = 1e-5
LOSS_RTOL = 1e-5
GRAD_RMS = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("src,dst", [
    ((506, 506), (64, 64)), ((634, 634), (80, 80)),
    ((128, 128), (512, 512)), ((32, 8), (128, 32)), ((58, 122), (8, 16))],
    ids=["cuboid-shrink", "cylinder-shrink", "x4", "x4-sector", "mixed"])
def test_resize_matches_jax(src, dst):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")``
    (antialiased by default) within float32 rounding; at the shrinking
    sizes torch's plain bilinear (no antialias) is far off, which is the
    trap the port avoids."""
    from partner_tpu_torch.models.seg_head import resize_bilinear

    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       "bilinear"))
    got = resize_bilinear(t(x), dst).numpy()
    assert got.shape == want.shape
    assert rel_rms(got, want) <= 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if dst[0] < src[0]:
        plain = F.interpolate(t(x).permute(0, 3, 1, 2), size=dst,
                              mode="bilinear", align_corners=False)
        assert rel_rms(plain.permute(0, 2, 3, 1).numpy(), want) > 0.1


# ------------------------------------------------------------------- heads

def _head_pair(jax_cls, port_cls, jax_kw, port_kw, canvas, feat, seed):
    rng = np.random.RandomState(seed)
    jhead = jax_cls(**jax_kw)
    v = randomize(drawn_init(jhead.init, rng, canvas, feat), rng)
    want = np.asarray(jhead.apply(v, canvas, feat)["seg_preds"])
    with torch.device("meta"):
        head = port_cls(**jax_kw, **port_kw)
    head = head.to_empty(device="cpu")
    load_converted(head, v)
    with torch.no_grad():
        got = head(t(canvas), t(feat))["seg_preds"].numpy()
    return got, want, v


@pytest.mark.parametrize("kernel", [1, 3])
def test_single_conv_head_matches_jax(kernel):
    """``SingleConvHead``: the neck's (2, 8, 4, 12) map grown x4 to the
    (32, 16) canvas, concatenated after its 5 channels, a k x k conv to 16
    classes: the logits within ``LOGIT_RMS``."""
    from partner_tpu.models.seg_head import SingleConvHead as JHead
    from partner_tpu_torch.models.seg_head import SingleConvHead

    rng = np.random.RandomState(1)
    canvas = rng.randn(2, 32, 16, 5).astype(np.float32)
    feat = rng.randn(2, 8, 4, 12).astype(np.float32)
    got, want, v = _head_pair(
        JHead, SingleConvHead, dict(num_classes=16, kernel=kernel),
        dict(canvas_channels=5, feat_channels=12), canvas, feat, 2)
    assert got.shape == want.shape == (2, 32, 16, 16)
    assert v["params"]["Conv_0"]["kernel"].shape == (kernel, kernel, 17, 16)
    assert rel_rms(got, want) <= LOGIT_RMS


@pytest.mark.parametrize("case", ["cuboid", "cylinder", "height-1", "5d"])
def test_deconv_conv_head_matches_jax(case):
    """``DeconvConvHead`` (``ConvTranspose_0``: kernel 16, stride 8, flax
    padding 8, the transposed layout of ``convert.flax_to_torch``): the
    seg configs' BEV canvases (64 x 64 cuboid, 80 x 80 cylinder), whose
    deconv outputs 506 x 506 and 634 x 634 shrink back by the antialiased
    resize; ``height`` 1 (``in_channels // up_scale`` deconv channels);
    and the 5-D canvas (B, D, H, W, C), height folded into the channels,
    which no config reaches. The logits within ``LOGIT_RMS``."""
    from partner_tpu.models.seg_head import DeconvConvHead as JHead
    from partner_tpu_torch.models.seg_head import DeconvConvHead

    hw = {"cuboid": 64, "cylinder": 80, "height-1": 16, "5d": 8}[case]
    rng = np.random.RandomState(3)
    kw = dict(num_classes=6, in_channels=32, up_scale=8, height=5)
    pk = dict(canvas_channels=4, feat_channels=6)
    canvas = rng.randn(1, hw, hw, 4).astype(np.float32)
    if case == "height-1":
        kw["height"] = 1
    if case == "5d":
        kw["num_classes"] = 3
        canvas = rng.randn(1, 3, hw, hw, 4).astype(np.float32)
        pk["canvas_depth"] = 3
    feat = rng.randn(1, hw, hw, 6).astype(np.float32)
    got, want, v = _head_pair(JHead, DeconvConvHead, kw, pk, canvas, feat, 4)
    assert got.shape == want.shape == canvas.shape[:-1] + (
        kw["num_classes"],)
    deconv = v["params"]["ConvTranspose_0"]["kernel"]
    assert deconv.shape == (16, 16, 6, 4 if case == "height-1" else 5)
    assert rel_rms(got, want) <= LOGIT_RMS
    if case in ("cuboid", "cylinder"):
        with torch.device("meta"):
            head = DeconvConvHead(**kw, **pk)
        up = head.ConvTranspose_0(torch.empty(1, hw, hw, 6, device="meta"))
        assert up.shape[1:3] == ((hw - 1) * 8 + 2,) * 2 == {
            64: (506, 506), 80: (634, 634)}[hw]


# ------------------------------------------------------------------ losses

def _loss_inputs(seed, n=600, c=6):
    """Logits (n, c) with planted ties (rows 0-39 share one logit row, so
    their errors tie in every class) and 1-based labels, 0 (ignored) on
    a fifth of the rows and class 3 absent."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, c).astype(np.float32)
    logits[:40] = logits[40]
    labels = rng.randint(1, c + 1, n)
    labels[labels == 4] = 5
    labels[rng.rand(n) < 0.2] = 0
    labels[:20] = 2
    return logits, labels.astype(np.int32)


def _jax_loss(name):
    from partner_tpu.models import seg_head as js

    if name == "cross_entropy_ignore":
        return lambda x, lab: js.cross_entropy_ignore(x, lab - 1)
    if name == "lovasz_grad":
        return lambda x, lab: (js.lovasz_grad(jax.nn.sigmoid(x[:, 0]))
                               * jnp.arange(1.0, x.shape[0] + 1)).sum()
    if name == "lovasz_softmax_flat":
        return lambda x, lab: js.lovasz_softmax_flat(
            jax.nn.softmax(x, -1), lab - 1, lab > 0)
    return lambda x, lab: js.seg_loss(x.reshape(4, 10, 15, -1),
                                      lab.reshape(4, 10, 15), weight=2.0)


def _port_loss(name):
    from partner_tpu_torch.models import seg_head as ts

    if name == "cross_entropy_ignore":
        return lambda x, lab: ts.cross_entropy_ignore(x, lab - 1)
    if name == "lovasz_grad":
        return lambda x, lab: (ts.lovasz_grad(torch.sigmoid(x[:, 0]))
                               * torch.arange(1.0, x.shape[0] + 1)).sum()
    if name == "lovasz_softmax_flat":
        return lambda x, lab: ts.lovasz_softmax_flat(
            torch.softmax(x, -1), lab - 1, lab > 0)
    return lambda x, lab: ts.seg_loss(x.reshape(4, 10, 15, -1),
                                      lab.reshape(4, 10, 15), weight=2.0)


@pytest.mark.parametrize("name", ["cross_entropy_ignore", "lovasz_grad",
                                  "lovasz_softmax_flat", "seg_loss"])
def test_loss_and_gradient_match_jax(name):
    """Each loss function on 600 rows of 6 classes (40 tied rows, a
    fifth ignored, a class absent): the value within ``LOSS_RTOL`` and the
    gradient of the logits within ``GRAD_RMS`` relative RMS of
    ``jax.grad`` (the Lovasz sort is stable in both, so tied rows take the
    same gradient; every row's gradient within 1e-5 of the largest)."""
    logits, labels = _loss_inputs(5)
    jf = _jax_loss(name)
    want, wgrad = jax.value_and_grad(jf)(jnp.asarray(logits),
                                         jnp.asarray(labels))
    x = t(logits).requires_grad_()
    got = _port_loss(name)(x, t(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    g, w = x.grad.numpy(), np.asarray(wgrad)
    assert rel_rms(g, w) <= GRAD_RMS, rel_rms(g, w)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_lovasz_ties_take_the_stable_order():
    """Rows 0-39 tie in every class. JAX's ``argsort(-errors)`` is stable,
    so the Lovasz gradient of the tied rows differs row by row in the
    sorted order; the port's stable sort gives the same per-row gradients
    (an unstable order would give the same loss and other gradients)."""
    from partner_tpu.models.seg_head import lovasz_softmax_flat as jl
    from partner_tpu_torch.models.seg_head import lovasz_softmax_flat

    logits, labels = _loss_inputs(6)
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    wgrad = np.asarray(jax.grad(lambda p: jl(p, jnp.asarray(labels) - 1,
                                             jnp.asarray(labels) > 0))(probs))
    p = t(np.asarray(probs)).requires_grad_()
    lab = t(labels)
    lovasz_softmax_flat(p, lab - 1, lab > 0).backward()
    tied = wgrad[:40]
    assert len(np.unique(tied[:, 1])) > 1   # ties get distinct gradients
    np.testing.assert_allclose(p.grad.numpy(), wgrad, rtol=0,
                               atol=1e-6 * np.abs(wgrad).max())


@pytest.mark.parametrize("decay", [None, 0.0, 0.5, 1.0, -1.0])
def test_apply_seg_decay_matches_jax(decay):
    """``apply_seg_decay`` (``models/detectors.py``) bit-equal to JAX's on
    float32 totals, and its gradient: ``det + seg x decay``, ``det +
    seg`` without a decay, and for a negative decay ``det + seg x det /
    (seg + 1e-6)`` with that ratio detached (d/dseg = det / (seg +
    1e-6), d/ddet = 1)."""
    from partner_tpu.models.detectors import apply_seg_decay as jdecay
    from partner_tpu_torch.models.detectors import apply_seg_decay

    det, seg = np.float32(3.7), np.float32(1.3)
    jex = {} if decay is None else {"seg_loss_decay": np.float32(decay)}
    want, wgrad = jax.value_and_grad(lambda a: jdecay(a[0], a[1], jex))(
        jnp.asarray([det, seg]))
    x = t(np.array([det, seg])).requires_grad_()
    ex = {} if decay is None else {"seg_loss_decay": decay}
    got = apply_seg_decay(x[0], x[1], ex)
    got.backward()
    assert float(got.detach()) == float(want)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(wgrad))


# ------------------------------------------------------------ grid helpers

def _grid_points(rng, pr, shape, n=4000):
    """(2, n, 5) points over ``pr`` widened by a cell, with rows planted on
    cell edges: lo + k x (float32 cell size), and lo + k x (float64 cell
    size) rounded to float32, where the two roundings of the size
    disagree; a mask dropping 5%."""
    d, h, w = (1,) + tuple(shape) if len(shape) == 2 else shape
    pr = np.asarray(pr, np.float64)
    pts = np.stack([rng.uniform(pr[i] - 1, pr[3 + i] + 1, (2, n))
                    for i in range(3)] + [rng.rand(2, n)] * 2, -1)
    sizes32 = [(np.float32(pr[3 + i]) - np.float32(pr[i])) / np.float32(m)
               for i, m in enumerate((w, h, d))]
    sizes64 = [(pr[3 + i] - pr[i]) / m for i, m in enumerate((w, h, d))]
    for i, m in enumerate((w, h, d)):
        k = rng.randint(0, m, 400)
        pts[:, :400, i] = np.float32(pr[i]) + k * sizes32[i]
        pts[:, 400:800, i] = np.float32(pr[i] + k * sizes64[i])
    mask = rng.rand(2, n) > 0.05
    return pts.astype(np.float32), mask


GRIDS = {
    "cylinder-2d": ([0.3, -3.1488, -5.0, 50.476, 3.1488, 3.0], (64, 80)),
    "cuboid-3d": ([-51.2, -51.2, -5.0, 51.2, 51.2, 3.0], (40, 64, 64)),
    "cylinder-3d": ([0.3, -3.1488, -5.0, 50.86, 3.1488, 3.0], (40, 80, 80)),
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_cells_and_majority_labels_match_jax(grid):
    """``points_to_grid_cells`` bit-equal to JAX's with points on cell edges
    (the float32 cell size puts some of them a cell from where a float64
    size would), then ``majority_grid_labels`` bit-equal with planted
    ties (a cell of two class-3 and two class-5 points takes 3), class-0
    points (never the majority) and a cell of unlabelled points only (0),
    17 classes."""
    from partner_tpu.models import seg_head as js
    from partner_tpu_torch.models import seg_head as ts

    pr, shape = GRIDS[grid]
    rng = np.random.RandomState(7)
    pts, mask = _grid_points(rng, pr, shape)
    labels = rng.randint(0, 17, (2, len(pts[0]))).astype(np.int32)
    # three cells of planted points: a 3/5 tie, class 0 against class 2,
    # and only class 0
    cells = [(0.37, 0.41), (0.63, 0.29), (0.12, 0.77)]
    plant = [[3, 3, 5, 5], [0, 0, 0, 2], [0, 0, 0, 0]]
    for j, ((fx, fy), labs) in enumerate(zip(cells, plant)):
        rows = slice(900 + 4 * j, 904 + 4 * j)
        pts[0, rows, 0] = pr[0] + fx * (pr[3] - pr[0])
        pts[0, rows, 1] = pr[1] + fy * (pr[4] - pr[1])
        pts[0, rows, 2] = 0.1
        mask[0, rows] = True
        labels[0, rows] = labs
        away = (np.abs(pts[0, :, 0] - pts[0, 900 + 4 * j, 0]) < 3) & \
            (np.abs(pts[0, :, 1] - pts[0, 900 + 4 * j, 1]) < 0.5)
        away[rows] = False
        mask[0, away] = False
    gi, ok = js.points_to_grid_cells(jnp.asarray(pts), jnp.asarray(mask),
                                     shape, pr)
    tgi, tok = ts.points_to_grid_cells(t(pts), t(mask), shape, pr)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(tgi.numpy()[tok.numpy()],
                                  np.asarray(gi)[np.asarray(ok)])
    # the float64 cell size would move some edge points
    d, h, w = (1,) + shape if len(shape) == 2 else shape
    col64 = np.floor((pts[..., 0].astype(np.float64) - pr[0])
                     / ((pr[3] - pr[0]) / w))
    assert (col64 != tgi.numpy()[..., 2]).any()
    want = np.asarray(js.majority_grid_labels(gi, ok, jnp.asarray(labels),
                                              shape, 16))
    got = ts.majority_grid_labels(tgi, tok, t(labels), shape, 16).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for j, expect in enumerate([3, 2, 0]):
        z, r, c = tgi.numpy()[0, 900 + 4 * j]
        cell = got[0, r, c] if len(shape) == 2 else got[0, z, r, c]
        assert cell == expect, (j, cell)


@pytest.mark.parametrize("ndim", [4, 5])
def test_point_labels_from_grid_match_jax(ndim):
    """``point_labels_from_grid`` bit-equal to JAX's on (B, [D,] H, W, C)
    maps with tied logits (argmax's first) and grid indices off the grid,
    negative and beyond (JAX wraps a negative index from the end, then
    clamps; callers mask those points)."""
    from partner_tpu.models import seg_head as js
    from partner_tpu_torch.models import seg_head as ts

    rng = np.random.RandomState(8)
    shape = (2, 3, 6, 5, 4) if ndim == 5 else (2, 6, 5, 4)
    sp = rng.randint(0, 3, shape).astype(np.float32)   # many ties
    gi = np.stack([rng.randint(-4, 5, (2, 300)), rng.randint(-8, 9, (2, 300)),
                   rng.randint(-7, 8, (2, 300))], -1).astype(np.int32)
    want = np.asarray(js.point_labels_from_grid(jnp.asarray(sp),
                                                jnp.asarray(gi)))
    got = ts.point_labels_from_grid(t(sp), t(gi)).numpy()
    np.testing.assert_array_equal(got, want)


def test_panoptic_fuse_matches_jax():
    """``panoptic_fuse`` (host numpy) equal to JAX's: thing points take the
    1-based index of the nearest kept box centre of their class above the
    score threshold."""
    from partner_tpu.eval.evaluator import NUSC_SEMANTIC2BOX
    from partner_tpu.models.seg_head import panoptic_fuse as jfuse
    from partner_tpu_torch.eval.evaluator import (NUSC_SEMANTIC2BOX as S2B,
                                                  NUSC_THING_CLASSES)
    from partner_tpu_torch.models.seg_head import panoptic_fuse

    assert S2B == NUSC_SEMANTIC2BOX
    rng = np.random.RandomState(9)
    labels = rng.randint(0, 17, 2000)
    xy = rng.uniform(-40, 40, (2000, 2))
    boxes = rng.uniform(-40, 40, (30, 7))
    blabels = rng.randint(0, 10, 30)
    scores = rng.rand(30)
    keep = rng.rand(30) > 0.2
    args = (labels, xy, boxes, blabels, scores, keep, NUSC_THING_CLASSES, S2B)
    got, want = panoptic_fuse(*args), jfuse(*args)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 100


# ------------------------------------------------------------------ metrics

def test_seg_metrics_match_jax():
    """``fast_hist``, ``per_class_iou`` and ``PanopticEval`` (PQ, SQ, RQ,
    per class too, and its semantic IoU) equal to JAX's over three frames
    of 17 classes with instances, some under ``min_points``."""
    from partner_tpu.eval import seg_metrics as jm
    from partner_tpu_torch.eval import seg_metrics as tm

    rng = np.random.RandomState(10)
    pe, jpe = tm.PanopticEval(17, ignore=[0]), jm.PanopticEval(17, ignore=[0])
    hist = jhist = 0
    for _ in range(3):
        gt = rng.randint(0, 17, 5000)
        pred = np.where(rng.rand(5000) < 0.7, gt, rng.randint(0, 17, 5000))
        gi = rng.randint(0, 6, 5000) * (gt < 11)
        pi = np.where(rng.rand(5000) < 0.8, gi, rng.randint(0, 6, 5000))
        hist = hist + tm.fast_hist(pred, gt, 17)
        jhist = jhist + jm.fast_hist(pred, gt, 17)
        pe.addBatch(pred, pi, gt, gi)
        jpe.addBatch(pred, pi, gt, gi)
    np.testing.assert_array_equal(hist, jhist)
    np.testing.assert_array_equal(tm.per_class_iou(hist),
                                  jm.per_class_iou(jhist))
    for g, w in zip(pe.getPQ() + pe.getSemIoU(), jpe.getPQ()
                    + jpe.getSemIoU()):
        np.testing.assert_array_equal(g, w)
    assert 0 < pe.getPQ()[0] < 1
