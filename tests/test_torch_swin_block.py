"""partner_tpu_torch whole-block route against the JAX package (CPU).

The block op's plain twin, fed the port's bias table, is held against the
Pallas whole-block kernel in interpret mode, in float32 and with a bf16
block input (in float32 every cast is a no-op, so only bf16 can show a
misplaced one). XLA's CPU backend may by default keep a bf16 intermediate
in f32 where the program rounds it (``xla_allow_excess_precision``), so
the reference is compiled with that off: it then rounds exactly where the
TPU kernel's code says. The port's ``SwinVoteTransformer(use_block_kernel=True)``
against JAX's on its interpret-mode kernel route. Sizes are those of
``tests/test_swin_block_pallas.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import jax_apply, jax_init, load_converted, randomize

torch.set_num_threads(2)

B, H, W, C, NH, WS = 2, 16, 8, 32, 2, 4


def _inputs(rng, cin=C):
    x = rng.randn(B, H, W, cin).astype(np.float32)
    pos = (rng.randn(B, H, W, 2) * 5).astype(np.float32)
    vote = rng.randn(B, H, W, 3).astype(np.float32)
    return x, pos, vote


def _models(rng, x, pos, vote, **jax_kw):
    """(JAX transformer, randomized variables, the port's transformer with
    them converted, on the whole-block route)."""
    from partner_tpu.models import swin_vote as jsv
    from partner_tpu_torch.models import swin_vote as tsv

    jm = jsv.SwinVoteTransformer(embed_dim=C, depth=2, num_heads=NH,
                                 window_size=WS, **jax_kw)
    v = randomize(jax_init(jm, x, pos, vote), rng)
    tm = tsv.SwinVoteTransformer(x.shape[-1], embed_dim=C, depth=2,
                                 num_heads=NH, window_size=WS,
                                 use_block_kernel=True)
    return jm, v, load_converted(tm, v)


def _block_case(rng, shift, dtype):
    """One block through the JAX interpret-mode kernel and the port's
    twin, on the same pre-rolled inputs: (port, JAX) outputs as f32."""
    from partner_tpu.models.swin_vote import swin_attn_mask
    from partner_tpu.ops.swin_block_pallas import swin_vote_block
    from partner_tpu_torch.ops import swin_block

    x, pos, vote = _inputs(rng)
    _, v, tm = _models(rng, x, pos, vote)
    name = "block1" if shift else "block0"
    roll = lambda a: np.roll(a, (-shift, -shift), axis=(1, 2))
    x, pos, vote = roll(x), roll(pos), roll(vote)
    mask = swin_attn_mask(H, W, WS, shift) if shift else None
    p = v["params"][name]
    a = p["attn"]
    jparams = {"ln1": p["norm1"], "ln2": p["norm2"], "qkv": a["qkv"],
               "proj": a["proj"], "vote_mlp": a["vote_mlp"], "rpe": a["rpe"],
               "tau": a["tau"], "mlp_fc1": p["mlp_fc1"],
               "mlp_fc2": p["mlp_fc2"]}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(pos), jnp.asarray(vote),
             mask, jparams)
    ref = swin_vote_block.lower(*jargs, nh=NH, ws=WS, interpret=True).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jargs)
    params = swin_block.swin_vote_block_params(getattr(tm, name), dtype)
    tmask = None if mask is None else torch.tensor(np.asarray(mask))
    bias = swin_block.block_bias_table(torch.from_numpy(pos), tmask,
                                       params["rpe"], dtype, WS)
    out = swin_block.swin_vote_block_plain(
        torch.from_numpy(x).to(dtype), torch.from_numpy(vote), bias, params,
        NH, WS)
    assert out.dtype == dtype
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("shift", [0, 2], ids=["unshifted", "shifted"])
def test_plain_block_matches_pallas_interpret_f32(rng, shift):
    out, ref = _block_case(rng, shift, torch.float32)
    # f32 LayerNorms, matmuls and softmax in another summation order
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shift", [0, 2], ids=["unshifted", "shifted"])
def test_plain_block_matches_pallas_interpret_bf16(rng, shift):
    out, ref = _block_case(rng, shift, torch.bfloat16)
    # Both sides round at the same points; an f32 sum taken in another
    # order can flip one bf16 rounding, which the later layers carry. So:
    # within 2 bf16 ulps relative, |out - ref| <= 2^-7 (1 + |ref|), and at
    # most 1% of the elements not bit-equal (0 measured). A cast moved or
    # dropped moves about half of the elements.
    err = np.abs(out - ref)
    assert np.all(err <= 2.0 ** -7 * (1 + np.abs(ref))), err.max()
    assert np.mean(err > 0) <= 0.01, np.mean(err > 0)


def test_transformer_block_route_matches_jax(rng):
    x, pos, vote = _inputs(rng, cin=24)
    jm, v, tm = _models(rng, x, pos, vote, use_block_kernel=True,
                        block_kernel_interpret=True)
    ref = jax_apply(jm, v, x, pos, vote, deterministic=True)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (x, pos, vote))).numpy()
    # patch embed, two blocks and the norms in f32, another summation order
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_block_route_falls_through_where_jax_does(rng):
    """A map that does not tile takes the per-block route on both sides
    (JAX: ``fused_ok`` needs exact tiling)."""
    x, pos, vote = (a[:, :10, :6] for a in _inputs(rng, cin=24))
    jm, v, tm = _models(rng, x, pos, vote, use_block_kernel=True,
                        block_kernel_interpret=True)
    ref = jax_apply(jm, v, x, pos, vote, deterministic=True)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (x, pos, vote))).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_block_wrapper_routes_by_device(rng):
    from partner_tpu_torch.ops import swin_block

    x, pos, vote = _inputs(rng)
    _, _, tm = _models(rng, x, pos, vote)
    params = swin_block.swin_vote_block_params(tm.block0, torch.float32)
    bias = swin_block.block_bias_table(torch.from_numpy(pos), None,
                                       params["rpe"], torch.float32, WS)
    args = (torch.from_numpy(x), torch.from_numpy(vote), bias, params, NH, WS)
    before = swin_block.swin_vote_block.launches
    np.testing.assert_array_equal(
        swin_block.swin_vote_block(*args).numpy(),
        swin_block.swin_vote_block_plain(*args).numpy())
    assert swin_block.swin_vote_block.launches == before  # plain: no launch
    meta = {k: (tuple(t.to("meta") for t in a) if k == "rpe" else
                a.to("meta")) for k, a in params.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        swin_block.swin_vote_block(args[0].to("meta"), args[1].to("meta"),
                                   bias.to("meta"), meta, NH, WS)
