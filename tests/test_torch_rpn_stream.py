"""The streaming necks ``RPNTECP`` and ``RPNBDCP`` in partner_tpu_torch
against the JAX package (CPU, float32).

Three scales as the PolarStream configs have them (strides 2, 2, 2) with
``us_layer_strides`` [0.5, 1, 2] (a 2x2 stride-2 conv, a 1x1 conv and a
transposed conv), narrow widths, one drawn flax tree with every norm
randomized: the outputs, every context and the BatchNorm statistics
through a chain of 4 sectors from sector 0, in eval and in train mode;
``RPNBDCP``'s leading-edge branch (the previous sweep's rows); and that
without that branch, as the JAX module calls it, ``RPNBDCP`` computes what
``RPNTECP`` computes on the same weights.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import drawn_init, load_converted, randomize

torch.set_num_threads(2)

# float32 both sides, another summation order: measured within 2e-6 of
# maps of magnitude ~1-5
TOL = 1e-5
NECK = dict(layer_nums=[1, 2, 1], ds_layer_strides=[2, 2, 2],
            ds_num_filters=[8, 8, 16], us_layer_strides=[0.5, 1, 2],
            us_num_filters=[8, 8, 8], num_input_features=6, nsectors=4)
SECTORS = 4
SHAPE = (2, 16, 16, 6)    # one sector's canvas (B, az, r, C)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(name, seed=0):
    """(JAX neck, its randomized drawn variables, the port neck loaded
    from them, the 4 sectors' canvases)."""
    from partner_tpu.models import rpn_stream as jrs
    from partner_tpu_torch.models import rpn_stream as trs

    rng = np.random.RandomState(seed)
    xs = [rng.randn(*SHAPE).astype(np.float32) for _ in range(SECTORS)]
    jneck = getattr(jrs, name)(**NECK)
    v = randomize(drawn_init(jneck.init, rng, xs[0], None, train=False), rng)
    tneck = load_converted(getattr(trs, name)(**NECK), v)
    return jneck, v, tneck, xs


def _jax_chain(jneck, v, xs, train, **kw):
    """The JAX neck over the sectors in order, contexts and (train mode)
    batch statistics threaded -> ([outputs], [contexts], final
    batch_stats), numpy."""
    fn = jax.jit(lambda v, x, ctx: jneck.apply(
        v, x, ctx, train=train, mutable=["batch_stats"] if train else False,
        **kw))
    outs, ctxs, ctx = [], [], None
    for x in xs:
        res = fn(v, x, ctx)
        if train:
            res, upd = res
            v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        out, ctx = res
        outs.append(np.asarray(out))
        ctxs.append([np.asarray(c) for c in ctx])
    return outs, ctxs, v["batch_stats"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["RPNTECP", "RPNBDCP"])
def test_neck_chain_matches_jax(name, train):
    """Sector 0 (zero padding at both azimuth ends), then three sectors
    each padded by the previous one's contexts: every output (B, 4, 4,
    24) and every context (the last input row of each of the 7 convs for
    ``RPNTECP``, the whole input for ``RPNBDCP``) within ``TOL``; in train
    mode every BatchNorm's running statistics after the 4 chained updates,
    one a sector in sector order, as flax chains them."""
    from partner_tpu_torch.convert import flax_to_torch

    jneck, v, tneck, xs = _pair(name)
    want_out, want_ctx, stats = _jax_chain(jneck, v, xs, train)
    tneck.train(train)
    ctx = None
    for s, x in enumerate(xs):
        with torch.no_grad():
            out, ctx = tneck(t(x), ctx)
        assert out.shape == want_out[s].shape == (2, 4, 4, 24)
        np.testing.assert_allclose(out.numpy(), want_out[s], rtol=TOL,
                                   atol=TOL, err_msg=f"sector {s}")
        assert len(ctx) == len(want_ctx[s]) == 7
        for i, (c, w) in enumerate(zip(ctx, want_ctx[s])):
            assert c.shape == w.shape, (s, i)
            np.testing.assert_allclose(c.numpy(), w, rtol=TOL, atol=TOL,
                                       err_msg=f"sector {s} context {i}")
    want = flax_to_torch({"batch_stats": jax.tree_util.tree_map(
        np.asarray, stats)})
    sd = tneck.state_dict()
    assert len(want) == 2 * 10
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=TOL,
                                   atol=1e-6, err_msg=k)
        moved += not np.array_equal(w.numpy(), flax_to_torch(
            {"batch_stats": v["batch_stats"]})[k].numpy())
    assert moved == (len(want) if train else 0)


def test_bdcp_leading_edge_matches_jax():
    """``RPNBDCP`` given the previous sweep's full maps (4 sectors wide at
    each conv's input resolution) at sector 2 after sector 1's contexts:
    the leading edge is row (2 + 1) x the sector's rows of each map,
    cyclic, as JAX slices it; outputs and contexts within ``TOL``, and the
    output differs from the zero-padded one."""
    jneck, v, tneck, xs = _pair("RPNBDCP", seed=3)
    with torch.no_grad():
        _, ctx = tneck(t(xs[0]), None)
    rng = np.random.RandomState(4)
    full = [rng.randn(c.shape[0], SECTORS * c.shape[1], *c.shape[2:])
            .astype(np.float32) for c in ctx]
    jctx = [c.numpy() for c in ctx]
    want, want_ctx = jax.jit(lambda v, x, c, f: jneck.apply(
        v, x, c, prev_sweep=f, sec_id=2, train=False))(v, xs[1], jctx, full)
    with torch.no_grad():
        got, got_ctx = tneck(t(xs[1]), ctx, prev_sweep=[t(f) for f in full],
                             sec_id=2)
        zero, _ = tneck(t(xs[1]), ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for g, w in zip(got_ctx, want_ctx):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    assert np.abs(got.numpy() - zero.numpy()).max() > 1e-2


def test_bdcp_without_prev_sweep_computes_tecp():
    """JAX's ``PolarStreamModule`` never passes ``prev_sweep`` to
    ``RPNBDCP`` (``polarstream.py:279``), so its leading edge pads zeros
    and the neck is ``RPNTECP`` on the same weights: both packages' outputs
    bit-equal between the two necks over a 4-sector chain, and each
    ``RPNBDCP`` context's last row is the ``RPNTECP`` context."""
    from partner_tpu.models import rpn_stream as jrs
    from partner_tpu_torch.models.rpn_stream import RPNTECP

    jneck, v, bdcp, xs = _pair("RPNBDCP", seed=5)
    tecp = load_converted(RPNTECP(**NECK), v)
    b_ctx = e_ctx = None
    for x in xs:
        with torch.no_grad():
            b_out, b_ctx = bdcp(t(x), b_ctx)
            e_out, e_ctx = tecp(t(x), e_ctx)
        assert torch.equal(b_out, e_out)
        for bc, ec in zip(b_ctx, e_ctx):
            assert torch.equal(bc[:, -1:], ec)
    j_b = _jax_chain(jneck, v, xs, False)
    j_e = _jax_chain(jrs.RPNTECP(**NECK), v, xs, False)
    for ob, oe in zip(j_b[0], j_e[0]):
        np.testing.assert_array_equal(ob, oe)


def test_one_sector_pads_zeros_not_circularly():
    """At sector 0 with no context (the 1-sector configs' only call) each
    conv pads its azimuth ends with zeros, in both packages: the first
    stride-1 conv's output is the conv of the zero-padded input, and
    differs from the conv of the input padded circularly at +-pi, as the
    reference's ``ConvContext`` pads a whole sweep
    (``rpn_context.py:11-14``), in the first and last azimuth rows only;
    the whole neck at sector 0 as JAX computes it."""
    import torch.nn.functional as F

    jneck, v, tneck, xs = _pair("RPNTECP", seed=6)
    x = t(np.random.RandomState(7).randn(2, 8, 8, 8).astype(np.float32))
    conv = tneck.block0_conv1
    with torch.no_grad():
        got, _ = conv(x, None)
        bn_relu = lambda y: torch.relu(conv.BatchNorm_0(y))
        zero = bn_relu(conv.Conv_0(F.pad(x, (0, 0, 1, 1, 1, 1))))
        ring = torch.cat([x[:, -1:], x, x[:, :1]], dim=1)
        circ = bn_relu(conv.Conv_0(F.pad(ring, (0, 0, 1, 1))))
    assert torch.equal(got, zero)
    differs = (circ - got).abs().amax(dim=(0, 2, 3)) > 1e-3
    assert differs.tolist() == [True] + [False] * (got.shape[1] - 2) + [
        True]
    want = jax.jit(lambda v, x: jneck.apply(v, x, None, train=False))(
        v, xs[0])[0]
    with torch.no_grad():
        out, _ = tneck(t(xs[0]), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_stream_neck_names_map_and_init():
    """The flax tree maps onto the port's modules by name alone: each
    ``block{i}_conv{li}`` holds ``Conv_0`` and ``BatchNorm_0``, each
    ``deblock{j}`` its ``_conv`` and ``_bn``; the transposed deblock
    (stride 2) keeps the Conv rule's layout (O, I, 2, 2), and a fresh port
    neck's kernels start at flax's spread."""
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models.layers import init_weights
    from partner_tpu_torch.models.rpn_stream import RPNTECP

    _, v, tneck, _ = _pair("RPNTECP")
    sd = tneck.state_dict()
    assert sorted(sd) == sorted(flax_to_torch(v))
    assert tuple(sd["deblock2_conv.weight"].shape) == (8, 16, 2, 2)
    assert tuple(sd["deblock0_conv.weight"].shape) == (8, 8, 2, 2)
    assert "deblock0_bn.running_var" in sd
    assert "block1_conv2.BatchNorm_0.running_mean" in sd
    fresh = RPNTECP(**NECK)
    init_weights(fresh, torch.Generator().manual_seed(0))
    w = fresh.deblock2_conv.weight.detach().numpy()
    # lecun normal over a fan in of 16 x 2 x 2, as flax's ConvTranspose
    assert abs(w.std() * np.sqrt(16 * 4) - 1) < 0.25


@pytest.mark.parametrize("name", ["RPNHalo", "RPNUber", "RPNWaymo",
                                  "RPNWaymoLSTM"])
def test_other_stream_necks_raise(name):
    from partner_tpu_torch.models.registry import NECKS, build_from_cfg

    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        build_from_cfg(dict(NECK, type=name), NECKS)
