"""The nuScenes DCN head and the double-flip decode in partner_tpu_torch
against the JAX package (CPU, float32).

``ops/deform_conv.py`` (the bilinear gather and the deformable conv, at 1
and 4 deformable groups, with and without the v2 mask, at integer,
fractional and out-of-image offsets) and its gradients against
``jax.grad``; ``FeatureAdaption``, ``DCNSepHead`` and ``CenterHead(dcn_head=
True)`` with converted, randomized weights in eval and train mode;
``double_flip_average`` and the ``pre_activated`` decode. Every input is
made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (NUSC_DCN as DCN, drawn_init, head_cfg,
                                 jax_apply, load_converted, randomize_dcn)

torch.set_num_threads(2)

OFFSETS = ("integer", "fractional", "outside")


def _offsets(rng, kind, shape):
    if kind == "integer":
        return rng.randint(-2, 3, shape).astype(np.float32)
    if kind == "fractional":
        return rng.uniform(-1.5, 1.5, shape).astype(np.float32)
    # most taps land off the 6 x 7 image, some straddle its edge
    return rng.uniform(-9.0, 9.0, shape).astype(np.float32)


def _conv_inputs(rng, groups, kind, with_mask, b=2, h=6, w=7, c=8, cout=5):
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = _offsets(rng, kind, (b, h, w, groups * 9 * 2))
    wt = (rng.randn(9, c, cout) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    mask = (rng.randn(b, h, w, groups * 9).astype(np.float32)
            if with_mask else None)
    return x, off, wt, bias, mask


def test_bilinear_sample_matches_jax(rng):
    from partner_tpu.ops.deform_conv import bilinear_sample_nhwc as jfn
    from partner_tpu_torch.ops.deform_conv import bilinear_sample_nhwc

    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    # whole, fractional and off-image coordinates, and exact edges
    ys = rng.uniform(-2.0, 7.0, (2, 5, 6, 9)).astype(np.float32)
    xs = rng.uniform(-2.0, 8.0, (2, 5, 6, 9)).astype(np.float32)
    ys[0, 0, :, :3] = np.round(ys[0, 0, :, :3])
    xs[1, :, 0, 4] = [-1.0, 0.0, 5.0, 6.0, -0.5]
    got = bilinear_sample_nhwc(*(torch.from_numpy(a) for a in (x, ys, xs)))
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs)))
    assert got.shape == want.shape == (2, 5, 6, 9, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.all(want[xs >= 7.0] == 0) and np.all(want[ys <= -1.0] == 0)


@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("with_mask", [False, True], ids=["v1", "v2-mask"])
@pytest.mark.parametrize("groups", [1, 4])
def test_deform_conv_matches_jax(rng, groups, with_mask, kind):
    from partner_tpu.ops.deform_conv import deform_conv2d as jfn
    from partner_tpu_torch.ops.deform_conv import deform_conv2d

    x, off, wt, bias, mask = _conv_inputs(rng, groups, kind, with_mask)
    got = deform_conv2d(*(torch.from_numpy(a) for a in (x, off, wt, bias)),
                        deformable_groups=groups,
                        mask=None if mask is None else torch.from_numpy(mask))
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt),
                          jnp.asarray(bias), deformable_groups=groups,
                          mask=None if mask is None else jnp.asarray(mask)))
    assert got.shape == want.shape == (2, 6, 7, 5)
    # a sum of 9 x 8 bilinear samples, another summation order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("groups,with_mask", [(1, False), (4, True)],
                         ids=["g1", "g4-mask"])
def test_deform_conv_gradients_match_jax(rng, groups, with_mask, kind):
    """The gradients of a seeded projection of the output with respect to
    the input, the offsets, the weight (and the mask) against
    ``jax.grad``, float32."""
    from partner_tpu.ops.deform_conv import deform_conv2d as jfn
    from partner_tpu_torch.ops.deform_conv import deform_conv2d

    x, off, wt, bias, mask = _conv_inputs(rng, groups, kind, with_mask)
    cot = rng.randn(2, 6, 7, 5).astype(np.float32)
    args = [x, off, wt] + ([mask] if with_mask else [])

    def jloss(x, off, wt, *m):
        out = jfn(x, off, wt, jnp.asarray(bias), deformable_groups=groups,
                  mask=m[0] if m else None)
        return (out * cot).sum()

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = deform_conv2d(targs[0], targs[1], targs[2],
                        torch.from_numpy(bias), deformable_groups=groups,
                        mask=targs[3] if with_mask else None)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("x", "offsets", "weight", "mask"), targs, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_feature_adaption_matches_jax(rng):
    from partner_tpu.models.center_head import FeatureAdaption as JFA
    from partner_tpu_torch.models.center_head import FeatureAdaption

    x = rng.randn(2, 8, 6, 16).astype(np.float32)
    jm = JFA(16)
    v = randomize_dcn(drawn_init(jm.init, rng, x), rng)
    want = jax_apply(jm, v, x)
    tm = load_converted(FeatureAdaption(16, 16), v)
    sd = tm.state_dict()
    # the rules of the converter: the 1x1 offset conv HWIO -> OIHW, the
    # raw deformable kernel and bias kept as flax holds them
    assert tuple(sd["conv_offset.weight"].shape) == (72, 16, 1, 1)
    assert tuple(sd["deform_kernel"].shape) == (9, 16, 16)
    np.testing.assert_array_equal(sd["deform_kernel"].numpy(),
                                  v["params"]["deform_kernel"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dcn_sep_head_matches_jax(rng, train):
    """``DCNSepHead`` in eval mode (running statistics) and in train mode
    (batch statistics, and the running statistics it leaves behind)."""
    from partner_tpu.models.center_head import DCNSepHead as JHead
    from partner_tpu_torch.models.center_head import DCNSepHead

    heads = {"dim": (3, 2), "height": (1, 2), "reg": (2, 2), "rot": (2, 2),
             "vel": (2, 2)}
    x = rng.randn(2, 8, 6, 16).astype(np.float32)
    jm = JHead(num_cls=2, heads=heads)
    v = randomize_dcn(drawn_init(jm.init, rng, x, train=False), rng)
    if train:
        want, upd = jax_apply(jm, v, x, train=True, mutable=["batch_stats"])
    else:
        want = jax_apply(jm, v, x, train=False)
    tm = load_converted(DCNSepHead(16, 2, heads), v)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert list(got) == list(want) == sorted(list(heads) + ["hm"])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if train:
        bn = upd["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(tm.BatchNorm_0.running_mean.numpy(),
                                   bn["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.BatchNorm_0.running_var.numpy(),
                                   bn["var"], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def dcn_head():
    """The JAX head of the DCN config's bbox_head at a 64-wide input, its
    randomized variables and an input, built once for both modes."""
    from partner_tpu.models import registry as jreg

    rng = np.random.RandomState(5)
    hc = dict(head_cfg(DCN), in_channels=64)
    x = rng.randn(1, 12, 10, 64).astype(np.float32)
    jhead = jreg.build_from_cfg(dict(hc), jreg.BBOX_HEADS)
    return hc, jhead, randomize_dcn(
        drawn_init(jhead.init, rng, x, train=False), rng), x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dcn_center_head_matches_jax(dcn_head, train):
    """The DCN config's 6-task, 10-class ``CenterHead(dcn_head=True)``,
    every leaf converted by name (strict load)."""
    from partner_tpu_torch.models import registry as treg

    hc, jhead, v, x = dcn_head
    assert hc["dcn_head"] is True
    ref = jax_apply(jhead, v, x, train=train,
                    **({"mutable": ["batch_stats"]} if train else {}))
    ref = (ref[0] if train else ref)["det_preds"]
    thead = load_converted(treg.build_from_cfg(dict(hc), treg.BBOX_HEADS), v)
    thead.train(train)
    with torch.no_grad():
        out = thead(torch.from_numpy(x))["det_preds"]
    assert len(out) == len(ref) == 6
    for task, (o, r) in enumerate(zip(out, ref)):
        assert list(o) == list(r) == sorted(r)
        assert r["hm"].shape[-1] == len(hc["tasks"][task]["class_names"])
        for k in r:
            np.testing.assert_allclose(o[k].numpy(), r[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"task{task} {k}")


def test_dcn_head_init_is_flax_init():
    """A fresh port head starts where a fresh flax head does: the offset
    convs zero (every branch a plain 3x3 conv), the deformable biases zero,
    ``hm_out``'s bias at ``init_bias``, the deformable kernels at a
    variance of 1 / (K C)."""
    from partner_tpu_torch.models.center_head import CenterHead
    from partner_tpu_torch.models.layers import init_weights

    head = CenterHead(**dict(head_cfg(DCN), in_channels=64))
    init_weights(head, torch.Generator().manual_seed(0))
    for i in range(6):
        t = getattr(head, f"task{i}")
        for br in (t.feature_adapt_cls, t.feature_adapt_reg):
            assert not br.conv_offset.weight.any()
            assert not br.deform_bias.any()
            assert abs(float(br.deform_kernel.std()) - (9 * 64) ** -0.5) < 0.01
        assert torch.all(t.hm_out.bias == -2.19)


def _flip_maps(rng, b4, h=6, w=5, vel=True):
    chans = {"dim": 3, "height": 1, "hm": 2, "reg": 2, "rot": 2}
    if vel:
        chans["vel"] = 2
    return {k: rng.randn(b4, h, w, c).astype(np.float32)
            for k, c in chans.items()}


def _flip_average_numpy(maps):
    """The double-flip average written out in numpy."""
    four = {}
    for k, v in maps.items():
        v = v.reshape(-1, 4, *v.shape[1:]).copy()
        v[:, 1] = v[:, 1, ::-1]
        v[:, 2] = v[:, 2, :, ::-1]
        v[:, 3] = v[:, 3, ::-1, ::-1]
        four[k] = v
    reg, rot = four["reg"], four["rot"]
    reg[:, 1, ..., 1] = 1 - reg[:, 1, ..., 1]
    reg[:, 2:, ..., 0] = 1 - reg[:, 2:, ..., 0]
    reg[:, 3, ..., 1] = 1 - reg[:, 3, ..., 1]
    rot[:, 1, ..., 1] *= -1
    rot[:, 2:, ..., 0] *= -1
    rot[:, 3, ..., 1] *= -1
    out = {"hm": (1 / (1 + np.exp(-four["hm"]))).mean(1),
           "dim": np.exp(four["dim"]).mean(1),
           "height": four["height"].mean(1), "reg": reg.mean(1),
           "rot": rot.mean(1)}
    if "vel" in four:
        vel = four["vel"]
        vel[:, 1, ..., 1] *= -1
        vel[:, 2, ..., 0] *= -1
        vel[:, 3] *= -1
        out["vel"] = vel.mean(1)
    return out


@pytest.mark.parametrize("samples", [1, 2])
def test_double_flip_average_matches_jax(rng, samples):
    """At 2 samples against the jitted JAX function. At one sample (4 rows)
    against the JAX function run op by op: there ``jax.jit`` of it is
    wrong on the CPU (ROADMAP.md §3: XLA fuses an in-place update with a
    reversed read of the same buffer), which the last assertion pins."""
    from partner_tpu.models.center_head import double_flip_average as jfn
    from partner_tpu_torch.models.center_head import double_flip_average

    maps = _flip_maps(rng, 4 * samples, h=32, w=16)
    got = double_flip_average({k: torch.from_numpy(v)
                               for k, v in maps.items()})
    jmaps = {k: jnp.asarray(v) for k, v in maps.items()}
    eager, jitted = jfn(jmaps), jax.jit(jfn)(jmaps)
    want = _flip_average_numpy(maps)
    assert sorted(got) == sorted(want) == sorted(eager)
    for k in want:
        assert got[k].shape == (samples, 32, 16, maps[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(eager[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        if samples == 2:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(jitted[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    if samples == 1:
        assert np.abs(np.asarray(jitted["hm"]) - want["hm"]).max() > 1e-2


@pytest.mark.parametrize("vel", [True, False], ids=["vel", "no-vel"])
def test_pre_activated_decode_matches_jax(rng, vel):
    """``center_head_decode(..., pre_activated=True)`` of averaged maps on
    the flip config's cuboid grid."""
    from partner_tpu.models.center_head import center_head_decode as jdec
    from partner_tpu.models.center_head import double_flip_average as jfn
    from partner_tpu_torch.models.center_head import center_head_decode

    maps = _flip_maps(rng, 8, h=12, w=10, vel=vel)
    avg = {k: np.asarray(v) for k, v in
           jax.jit(jfn)({k: jnp.asarray(v) for k, v in maps.items()}).items()}
    avg["dim"] = np.abs(avg["dim"])
    vs, pr = [0.075, 0.075, 0.2], [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]
    wb, ws = jax.jit(lambda p: jdec(p, (12, 10), vs, pr, 8, "cuboid",
                                    pre_activated=True))(avg)
    tb, ts = center_head_decode({k: torch.from_numpy(v)
                                 for k, v in avg.items()}, (12, 10), vs, pr,
                                8, "cuboid", pre_activated=True)
    assert tb.shape == (2, 120, 9 if vel else 7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    np.testing.assert_allclose(tb.numpy(), np.asarray(wb), rtol=1e-6,
                               atol=1e-6)
    # the maps are read as they are: no sigmoid, no exp
    np.testing.assert_array_equal(ts.numpy(), avg["hm"].reshape(2, 120, 2))
    np.testing.assert_array_equal(tb[..., 3:6].numpy(),
                                  avg["dim"].reshape(2, 120, 3))
