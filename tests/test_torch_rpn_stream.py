"""The streaming necks in partner_tpu_torch against the JAX package (CPU,
float32): ``RPNTECP`` and ``RPNBDCP`` (PolarStream), ``RPNUber``
(STROBE), ``RPNWaymo`` / ``RPNWaymoLSTM`` with its ``ConvLSTMCell``
(HAN) and ``RPNHalo``.

Three scales as the configs have them (strides 2, 2, 2) with
``us_layer_strides`` [0.5, 1, 2] (a 2x2 stride-2 conv, a 1x1 conv and a
transposed conv), narrow widths, one drawn flax tree with every norm
randomized: the outputs, every context and the BatchNorm statistics
through a chain of 4 sectors from sector 0, in eval and in train mode;
``RPNBDCP``'s leading-edge branch (the previous sweep's rows); and that
without that branch, as the JAX module calls it, ``RPNBDCP`` computes what
``RPNTECP`` computes on the same weights. The plain-conv necks: each
without and with its context or state over a chain of 3 calls, eval and
train; their convs' explicit padding 1 at stride 2 (not "SAME"); the
halo's circular pad.
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
    """These names, once registered as raises naming queue 1 item 7, build
    the ported necks (held against JAX below), their parameters named as
    flax names them. The halo neck's mesh form (an ``axis_name``: a ring
    halo across shards, ``tests/test_torch_halo.py``) builds too, and its
    forward raises while no process group is registered under that name,
    as an unbound axis name raises in JAX."""
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import rpn_stream as trs
    from partner_tpu_torch.models.registry import NECKS, build_from_cfg

    neck = build_from_cfg(dict(NECK, type=name), NECKS)
    assert type(neck).__name__ == {"RPNWaymo": "RPNWaymoLSTM"}.get(name,
                                                                   name)
    _, v, tneck, _ = _plain_pair(type(neck).__name__)
    assert sorted(neck.state_dict()) == sorted(flax_to_torch(v))
    if name == "RPNHalo":
        sharded = build_from_cfg(dict(NECK, type=name, axis_name="azimuth"),
                                 NECKS)
        assert sorted(sharded.state_dict()) == sorted(neck.state_dict())
        with pytest.raises(NameError, match="unbound axis name 'azimuth'"):
            sharded(torch.zeros(1, 8, 8, NECK["num_input_features"]))
    assert isinstance(trs.NECKS.get(name)(**NECK), trs._StreamRPNBase)


# ------------------------------------------ RPNUber, RPNWaymoLSTM, RPNHalo

PLAIN = ("RPNUber", "RPNWaymoLSTM", "RPNHalo")


def _plain_pair(name, seed=0):
    """(JAX neck, its randomized drawn variables, the port neck, 3 inputs
    (2, 16, 16, 6)) for a plain-conv neck."""
    from partner_tpu.models import rpn_stream as jrs
    from partner_tpu_torch.models import rpn_stream as trs

    rng = np.random.RandomState(seed)
    xs = [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]
    jneck = getattr(jrs, name)(**NECK)
    args = (xs[0],) if name == "RPNHalo" else (xs[0], None)
    v = randomize(drawn_init(jneck.init, rng, *args, train=False), rng)
    return jneck, v, load_converted(getattr(trs, name)(**NECK), v), xs


def _tree(c, fn):
    return (tuple(fn(x) for x in c) if isinstance(c, tuple)
            else [fn(x) for x in c])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", PLAIN)
def test_plain_neck_chain_matches_jax(name, train):
    """Three calls in a row: the first without a context (``RPNUber``
    concatenates zeros, ``RPNWaymoLSTM`` starts from a zero state), the
    next two given the previous call's contexts (``RPNUber``: each
    scale's input before the concat, 3 maps; ``RPNWaymoLSTM``: the
    ConvLSTM's (h, c)); ``RPNHalo`` takes none. Every output (2, 4, 4,
    24), context and, in train mode, BatchNorm statistic within ``TOL``
    of JAX's, the statistics after the 3 chained updates."""
    from partner_tpu_torch.convert import flax_to_torch

    jneck, v, tneck, xs = _plain_pair(name, seed=8)
    halo = name == "RPNHalo"
    fn = jax.jit(lambda v, x, ctx: jneck.apply(
        v, x, *(() if halo else (ctx,)), train=train,
        mutable=["batch_stats"] if train else False))
    tneck.train(train)
    ctx = tctx = None
    for i, x in enumerate(xs):
        res = fn(v, x, ctx)
        if train:
            res, upd = res
            v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        with torch.no_grad():
            got = tneck(t(x)) if halo else tneck(t(x), tctx)
        if halo:
            res, got = (res, None), (got, None)
        assert got[0].shape == res[0].shape == (2, 4, 4, 24)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(res[0]),
                                   rtol=TOL, atol=TOL, err_msg=f"call {i}")
        if not halo:
            assert len(got[1]) == len(res[1]) == (3 if name == "RPNUber"
                                                  else 2)
            for g, w in zip(got[1], res[1]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=TOL, atol=TOL)
            ctx, tctx = _tree(res[1], np.asarray), got[1]
    if train:
        want = flax_to_torch({"batch_stats": jax.tree_util.tree_map(
            np.asarray, v["batch_stats"])})
        sd = tneck.state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=TOL,
                                       atol=1e-6, err_msg=k)


def test_explicit_padding_one_at_stride_two():
    """``RPNUber`` and ``RPNWaymoLSTM`` hand flax ``padding=1``: one row
    and column of zeros on both sides, at stride 2 too, where "SAME" (the
    plain ``RPN``'s flax default) pads 0 before and 1 after. The port's
    first conv of ``RPNUber`` (stride 2) equals the conv of the input
    padded 1 all round and differs from the "SAME" one, in both
    packages."""
    import flax.linen as fnn
    import torch.nn.functional as F

    _, _, tneck, xs = _plain_pair("RPNUber", seed=9)
    conv = tneck.block0_conv0
    x = torch.cat([t(xs[0]), torch.zeros_like(t(xs[0]))], dim=-1)
    w = conv.weight
    with torch.no_grad():
        got = conv(x)
        ones = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)), w,
                        stride=2).permute(0, 2, 3, 1)
        same = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)), w,
                        stride=2).permute(0, 2, 3, 1)
    assert got.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), ones.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert (got - same).abs().max() > 1e-2
    kernel = w.detach().numpy().transpose(2, 3, 1, 0)
    for pad, want in ((1, ones), ("SAME", same)):
        y = fnn.Conv(8, (3, 3), strides=(2, 2), padding=pad,
                     use_bias=False).apply({"params": {"kernel": kernel}},
                                           x.numpy())
        np.testing.assert_allclose(np.asarray(y), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_halo_is_a_circular_azimuth_pad():
    """Each of ``RPNHalo``'s convs sees its input with the last azimuth row
    in front and the first after, and a zero column at both range ends:
    the first conv's input, caught inside the neck, is exactly that
    padding of the canvas; its output (stride 2: the windows start at
    padded rows 0, 2, 4, 6 of 10, so only the first reads a wrapped row)
    differs from the conv of the zero-padded canvas (the 1-sector stream
    necks' pad) in the first azimuth row only."""
    import torch.nn.functional as F

    _, _, tneck, _ = _plain_pair("RPNHalo", seed=10)
    x = t(np.random.RandomState(11).randn(2, 8, 8, 6).astype(np.float32))
    seen = []
    hook = tneck.block0_conv0.register_forward_pre_hook(
        lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        tneck(x)
    hook.remove()
    ring = F.pad(torch.cat([x[:, -1:], x, x[:, :1]], 1), (0, 0, 1, 1))
    assert torch.equal(seen[0], ring)
    with torch.no_grad():
        got = tneck.block0_conv0(ring)
        zero = tneck.block0_conv0(F.pad(x, (0, 0, 1, 1, 1, 1)))
    differs = (zero - got).abs().amax(dim=(0, 2, 3)) > 1e-3
    assert differs.tolist() == [True, False, False, False]


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_conv_lstm_cell_matches_jax(with_state):
    """``ConvLSTMCell`` alone: the ``gates`` conv (bias, "SAME") of [x, h]
    split (i, f, g, o), the forget gate at sigmoid(f + 1): from a zero
    state and from a drawn (h, c), h' and c' within ``TOL`` of JAX's;
    with a zero state and zero gates the new c is sigmoid(0) tanh(0) =
    0 and h' 0, and with zero gates a carried c is kept at sigmoid(1)."""
    from partner_tpu.models.rpn_stream import ConvLSTMCell as JCell
    from partner_tpu_torch.models.rpn_stream import ConvLSTMCell

    rng = np.random.RandomState(12)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    state = (tuple(rng.randn(2, 8, 8, 5).astype(np.float32)
                   for _ in range(2)) if with_state else None)
    jc = JCell(5)
    v = randomize(drawn_init(jc.init, rng, x, state), rng)
    cell = load_converted(ConvLSTMCell(6, 5), v)
    wh, (_, wc) = jc.apply(v, x, state)
    with torch.no_grad():
        gh, (_, gc) = cell(t(x), None if state is None
                           else tuple(t(a) for a in state))
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=TOL,
                                   atol=TOL)
        cell.gates.weight.zero_()
        cell.gates.bias.zero_()
        c0 = torch.full((2, 8, 8, 5), 2.0)
        h1, (_, c1) = cell(t(x), (torch.zeros_like(c0), c0))
        np.testing.assert_allclose(c1.numpy(), torch.sigmoid(
            torch.tensor(1.0)).item() * 2.0, rtol=1e-6)
        h0, (_, z) = cell(t(x), None)
        assert float(z.abs().max()) == 0.0 and float(h0.abs().max()) == 0.0
