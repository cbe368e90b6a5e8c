"""partner_tpu_torch stem and point path against the JAX package (CPU, f32).

The port's plain stem twin is held against the Pallas stem kernel run in
interpret mode, the plain scatter-max twin against ``scatter_canvas``
(fold2d), and ``PolarDenseFHD.encode_points`` against the JAX point path
on a small grid, with converted, randomized weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import jax_apply, jax_init, load_converted, randomize

torch.set_num_threads(2)


def _stem_inputs(rng, b=2, p=300):
    x = rng.randn(b, 10, p).astype(np.float32)
    mask = rng.rand(b, p) > 0.2
    w1 = (rng.randn(32, 10) * 0.3).astype(np.float32)
    w2 = (rng.randn(64, 32) * 0.2).astype(np.float32)
    a1, a2 = (rng.uniform(0.5, 1.5, f).astype(np.float32) for f in (32, 64))
    b1, b2 = (rng.normal(0, 0.2, f).astype(np.float32) for f in (32, 64))
    return x, mask, w1, a1, b1, w2, a2, b2


@pytest.mark.parametrize("p", [1, 17, 300])
def test_plain_stem_matches_pallas_interpret(rng, p):
    """P = 1, 17 and 300: one point, a ragged count, several chunks of the
    kernel's 128-point tiles (the card kernel takes any P)."""
    from partner_tpu.ops import stem_pallas
    from partner_tpu_torch.ops import stem

    args = _stem_inputs(rng, p=p)
    x, mask, *w = args
    ref = np.stack([
        np.asarray(stem_pallas.stem2_channel_major(
            jnp.asarray(x[i]), jnp.asarray(mask[i]),
            *(jnp.asarray(a) for a in w), interpret=True, chunk=128))
        for i in range(x.shape[0])])
    out = stem.stem2_channel_major_plain(*(torch.from_numpy(a) for a in args))
    assert out.shape == ref.shape and out.dtype == torch.float32
    # pure f32 elementwise math around K=10/32 f32 matmuls: rounding only
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_stem_wrapper_routes_by_device(rng):
    from partner_tpu_torch.ops import stem

    args = [torch.from_numpy(a) for a in _stem_inputs(rng, b=1, p=40)]
    before = stem.stem2_channel_major.launches
    out = stem.stem2_channel_major(*args)
    np.testing.assert_array_equal(
        out.numpy(), stem.stem2_channel_major_plain(*args).numpy())
    assert stem.stem2_channel_major.launches == before  # plain: no launch
    with pytest.raises(ValueError, match="unsupported device"):
        stem.stem2_channel_major(*(a.to("meta") for a in args))


def _scatter_inputs(rng, shape=(3, 8, 6), b=2, p=500, c=4, cells=None,
                    keep=0.7):
    """Channel-major post-ReLU rows with masked rows (a share ``keep``
    kept), many ties (values on a 0.25 grid, a third of them zero) and
    -0.0 values; with ``cells``, every row in one of that many cells."""
    feats = np.maximum(np.round(rng.randn(b, c, p) * 4) / 4, 0.0)
    feats[rng.rand(b, c, p) < 0.2] = -0.0
    coords = np.stack([rng.randint(0, s, (b, p)) for s in shape],
                      1).astype(np.int32)                   # (b, 3, p)
    if cells is not None:
        coords = coords[:, :, rng.randint(0, p, cells)][
            :, :, rng.randint(0, cells, p)]
    mask = rng.rand(b, p) < keep
    return feats.astype(np.float32), coords, mask


# the card kernel's edge cases, held here for the twin it is compared with
SCATTER_CASES = {"default": {}, "3-cells": dict(cells=3, p=2000),
                 "p-not-8": dict(p=501), "all-masked": dict(keep=0.0)}


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_canvas_fold2d_matches_jax(rng, case):
    from partner_tpu.models.backbone_dense import scatter_canvas
    from partner_tpu_torch.ops.scatter_max import scatter_max_fold2d_plain

    shape = (3, 8, 6)
    feats, coords, mask = _scatter_inputs(rng, shape, **SCATTER_CASES[case])
    assert np.any(np.signbit(feats) & (feats == 0))
    if case == "3-cells":
        assert len({tuple(c) for c in coords[0].T}) <= 3
    ref, _ = scatter_canvas(jnp.asarray(feats.transpose(0, 2, 1)),
                            jnp.asarray(coords.transpose(0, 2, 1)),
                            jnp.asarray(mask), shape, 1, 1, fold2d=True)
    out = scatter_max_fold2d_plain(torch.from_numpy(feats),
                                   torch.from_numpy(coords),
                                   torch.from_numpy(mask), shape)
    # a max picks one of its inputs: exact (-0.0 == 0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_scatter_wrapper_routes_by_device(rng):
    from partner_tpu_torch.ops import scatter_max

    args = [torch.from_numpy(a) for a in _scatter_inputs(rng)]
    before = scatter_max.scatter_max_fold2d.launches
    np.testing.assert_array_equal(
        scatter_max.scatter_max_fold2d(*args, (3, 8, 6)).numpy(),
        scatter_max.scatter_max_fold2d_plain(*args, (3, 8, 6)).numpy())
    assert scatter_max.scatter_max_fold2d.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        scatter_max.scatter_max_fold2d(*(a.to("meta") for a in args),
                                       (3, 8, 6))


@pytest.mark.parametrize("size", [(8, 6), (7, 9)])
def test_stride2_same_conv_pads_like_xla(rng, size):
    """flax "SAME" at stride 2 pads (0, 1) on an even axis: the port's conv
    must match, where torch's symmetric padding=1 would shift the output."""
    import flax.linen as fnn

    from partner_tpu_torch.models.layers import Conv2d

    x = rng.randn(1, *size, 3).astype(np.float32)
    conv = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME",
                    use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(v, jnp.asarray(x)))
    tconv = Conv2d(3, 4, 3, 2, "SAME", use_bias=False)
    load_converted(tconv, v)
    out = tconv(torch.from_numpy(x)).detach().numpy()
    # one 27-term f32 conv: summation order only
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_encode_points_matches_jax(rng):
    from partner_tpu.models.backbone_dense import PolarDenseFHD as JaxFHD
    from partner_tpu_torch.models.backbone_dense import PolarDenseFHD

    from torch_port_fixtures import synthetic_points

    grid = (64, 128, 40)
    pr = (0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0)
    pts, mask = synthetic_points(rng, pr, 900, 1000)
    kw = dict(num_input_features=7, trunk2d=True, a2d_features=16,
              out_features=24)
    jm = JaxFHD(compute_dtype=jnp.float32, **kw)

    def enc(m, p, k):
        return m.encode_points(p, k, grid, pr, train=False)

    v = randomize(jax_init(jm, pts, mask, method=enc), rng)
    ref, _ = jax_apply(jm, v, pts, mask, method=enc)
    tm = PolarDenseFHD(compute_dtype="float32", input_shape=grid, **kw)
    load_converted(tm, v)
    with torch.no_grad():
        out = tm.encode_points(torch.from_numpy(pts), torch.from_numpy(mask),
                               grid, pr)
    assert tuple(out.shape) == ref.shape == (1, 16, 8, 24)
    # f32 convs and matmuls in another summation order: ~1e-4 relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))
