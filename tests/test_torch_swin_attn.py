"""partner_tpu_torch window attention against the JAX package (CPU, f32).

The plain attention twin is held against the Pallas kernel in interpret
mode; WindowAttention and SwinVoteTransformer against the JAX modules,
whose default path pre-normalizes q and k where the kernel divides the
logits: in float32 the two agree to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import jax_apply, jax_init, load_converted, randomize

torch.set_num_threads(2)


def _attn_inputs(rng, nw=6, nh=4, t=16, hd=8, mask_windows=6):
    q, k, v = (rng.randn(nw, nh, t, hd).astype(np.float32) for _ in range(3))
    pos = (rng.randn(nw, t, 2) * 10.0).astype(np.float32)
    mask = None
    if mask_windows:
        regions = rng.randint(0, 3, (mask_windows, t))
        mask = np.where(regions[:, :, None] != regions[:, None, :], -100.0,
                        0.0).astype(np.float32)
    w1 = (rng.randn(2, 16) * 0.3).astype(np.float32)
    b1 = (rng.randn(16) * 0.1).astype(np.float32)
    w2 = (rng.randn(16, nh) * 0.3).astype(np.float32)
    b2 = (rng.randn(nh) * 0.1).astype(np.float32)
    tau = rng.uniform(0.2, 1.2, nh).astype(np.float32)
    return [q, k, v, pos, mask, w1, b1, w2, b2, tau]


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("mask_windows", [6, 3, 0],
                         ids=["mask", "mask-tiled", "no-mask"])
def test_plain_attention_matches_pallas_interpret(rng, mask_windows):
    from partner_tpu.ops.swin_attn_pallas import swin_vote_attention
    from partner_tpu_torch.ops import swin_attn

    args = _attn_inputs(rng, mask_windows=mask_windows)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    if mask_windows == 3:  # the JAX caller tiles the per-sample mask
        jargs[4] = jnp.tile(jargs[4], (2, 1, 1))
    ref = np.asarray(swin_vote_attention(*jargs, interpret=True, g=2))
    out = swin_attn.swin_vote_attention_plain(*_torch(args))
    # f32 logits, RPE MLP and softmax in another summation order
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask_map", [(16, 16), (8, 16), None],
                         ids=["mask", "mask-tiled", "no-mask"])
def test_plain_attention_matches_pallas_interpret_bf16(rng, mask_map):
    """The twin that the card kernel is held to, at the kernel's own shape
    (4 heads, T 64, hd 64, RPE hidden 16) with bf16 q, k, v and cell
    positions up to 75 m, against the Pallas kernel in interpret mode. The
    reference is compiled with ``xla_allow_excess_precision`` off, so XLA
    rounds P and the output to bf16 where the TPU kernel's code does."""
    from partner_tpu.ops.swin_attn_pallas import swin_vote_attention
    from partner_tpu_torch.models.swin_vote import swin_attn_mask
    from partner_tpu_torch.ops import swin_attn

    nw = 4
    args = _attn_inputs(rng, nw=nw, t=64, hd=64, mask_windows=0)
    args[3] = rng.uniform(0.0, 75.0, (nw, 64, 2)).astype(np.float32)
    if mask_map is not None:  # (16, 16): 4 windows; (8, 16): 2, tiled 2x
        args[4] = swin_attn_mask(*mask_map, 8, 4)
    targs = _torch(args)
    targs[:3] = [a.to(torch.bfloat16) for a in targs[:3]]
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jargs[:3] = [a.astype(jnp.bfloat16) for a in jargs[:3]]
    if mask_map is not None:
        jargs[4] = jnp.tile(jargs[4], (nw // args[4].shape[0], 1, 1))
    ref = swin_vote_attention.lower(*jargs, interpret=True, g=2).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jargs)
    ref = np.asarray(ref.astype(jnp.float32))
    out = swin_attn.swin_vote_attention_plain(*targs)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    # Both round P and the output to bf16 from f32 sums taken in another
    # order, which can flip a rounding: within 2 bf16 ulps relative,
    # |out - ref| <= 2^-7 (1 + |ref|), the card kernel's bound, and at most
    # 1% of the elements not bit-equal (0.008-0.055% measured). P left in
    # f32 stays within the bound but moves about a third of them.
    err = np.abs(out - ref)
    assert np.all(err <= 2.0 ** -7 * (1 + np.abs(ref))), err.max()
    assert np.mean(err > 0) <= 0.01, np.mean(err > 0)


def test_attention_wrapper_routes_by_device(rng):
    from partner_tpu_torch.ops import swin_attn

    args = _torch(_attn_inputs(rng, nw=2, mask_windows=2))
    before = swin_attn.swin_vote_attention.launches
    np.testing.assert_array_equal(
        swin_attn.swin_vote_attention(*args).numpy(),
        swin_attn.swin_vote_attention_plain(*args).numpy())
    assert swin_attn.swin_vote_attention.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        swin_attn.swin_vote_attention(*(a.to("meta") for a in args))


@pytest.mark.parametrize("shift", [0, 2, 4])
def test_swin_mask_and_windows_match_jax(rng, shift):
    from partner_tpu.models import swin_vote as jsv
    from partner_tpu_torch.models import swin_vote as tsv

    ref = jsv.swin_attn_mask(16, 24, 8, shift)
    out = tsv.swin_attn_mask(16, 24, 8, shift)
    if shift == 0:
        assert ref is None and out is None
    else:
        np.testing.assert_array_equal(out, np.asarray(ref))
    x = rng.randn(2, 16, 24, 3).astype(np.float32)
    win = tsv.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(win.numpy(),
                                  np.asarray(jsv.window_partition(x, 8)))
    np.testing.assert_array_equal(
        tsv.window_reverse(win, 8, 2, 16, 24).numpy(), x)


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_matches_jax(rng, with_mask):
    from partner_tpu.models import swin_vote as jsv
    from partner_tpu_torch.models import swin_vote as tsv

    nb, t, c, nh = 4, 16, 32, 4
    x = rng.randn(nb, t, c).astype(np.float32)
    pos = (rng.randn(nb, t, 2) * 5).astype(np.float32)
    vote = rng.randn(nb, t, 3).astype(np.float32)
    mask = (_attn_inputs(rng, nw=2, nh=nh, t=t, mask_windows=2)[4]
            if with_mask else None)
    jm = jsv.WindowAttention(dim=c, num_heads=nh)
    v = randomize(jax_init(jm, x, pos, vote), rng)
    ref = jax_apply(jm, v, x, pos, vote, mask, deterministic=True)
    tm = load_converted(tsv.WindowAttention(c, nh), v)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(pos),
                 torch.from_numpy(vote),
                 None if mask is None else torch.from_numpy(mask))
    # pre-normalized vs divided cosine logits and f32 matmuls: rounding
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_swin_vote_transformer_matches_jax(rng):
    from partner_tpu.models import swin_vote as jsv
    from partner_tpu_torch.models import swin_vote as tsv

    b, h, w, cin = 1, 16, 16, 24
    x = rng.randn(b, h, w, cin).astype(np.float32)
    pos = (rng.randn(b, h, w, 2) * 5).astype(np.float32)
    vote = rng.randn(b, h, w, 3).astype(np.float32)
    jm = jsv.SwinVoteTransformer(embed_dim=32, depth=2, num_heads=4,
                                 window_size=8)
    v = randomize(jax_init(jm, x, pos, vote), rng)
    ref = jax_apply(jm, v, x, pos, vote, deterministic=True)
    tm = load_converted(tsv.SwinVoteTransformer(cin, embed_dim=32, depth=2,
                                                num_heads=4, window_size=8), v)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (x, pos, vote))).numpy()
    # two blocks of f32 matmuls/LayerNorms in another summation order
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(10, 6), (7, 8)], ids=["10x6", "7x8"])
def test_swin_vote_transformer_pads_maps_that_do_not_tile(rng, hw):
    """A map that is not a whole number of windows: padded to them, pad
    keys masked in the plain attention, output cropped (JAX
    ``swin_vote.py:267-307``); depth 2 covers the unshifted and the
    shifted block."""
    from partner_tpu.models import swin_vote as jsv
    from partner_tpu_torch.models import swin_vote as tsv

    (h, w), cin = hw, 24
    x = rng.randn(2, h, w, cin).astype(np.float32)
    pos = (rng.randn(2, h, w, 2) * 5).astype(np.float32)
    vote = rng.randn(2, h, w, 3).astype(np.float32)
    jm = jsv.SwinVoteTransformer(embed_dim=32, depth=2, num_heads=2,
                                 window_size=4)
    v = randomize(jax_init(jm, x, pos, vote), rng)
    ref = jax_apply(jm, v, x, pos, vote, deterministic=True)
    tm = load_converted(tsv.SwinVoteTransformer(cin, embed_dim=32, depth=2,
                                                num_heads=2, window_size=4), v)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (x, pos, vote))).numpy()
    assert out.shape == (2, h, w, 32)
    # the same plain attention formulation on both sides, f32, another
    # summation order
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
