"""partner_tpu_torch SetBlock, RPN and E2E head against the JAX modules
(CPU, f32), with converted weights and every norm parameter and statistic
randomized; plus the numerical conventions the port must carry over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import jax_apply, jax_init, load_converted, randomize

torch.set_num_threads(2)

# f32 convs, matmuls and LayerNorms in another summation order
RTOL = ATOL = 1e-4


def _small_var(v, rng):
    """Set every BN var (in place) to 1e-4..1e-3, comparable to the BN
    eps, so a wrong eps shows."""
    def walk(t):
        for k, x in t.items():
            if isinstance(x, dict):
                walk(x)
            elif k.endswith("var"):
                t[k] = rng.uniform(1e-4, 1e-3, x.shape).astype(np.float32)

    walk(v["batch_stats"])
    return v


@pytest.mark.parametrize("stats", ["unit", "eps-sized"])
def test_set_block_stack_matches_jax(rng, stats):
    from partner_tpu.models.set_transformer import SetBlockStack as JSB
    from partner_tpu_torch.models.set_transformer import SetBlockStack

    b, h, w, c = 1, 12, 16, 32
    x = rng.randn(b, h, w, c).astype(np.float32)
    pos = (rng.randn(b, h, w, 2) * 20).astype(np.float32)
    jm = JSB(depth=2, num_heads=4, num_keypoints=4, range_window=8)
    v = randomize(jax_init(jm, x, pos, train=False), rng)
    if stats == "eps-sized":
        v = _small_var(v, rng)
    ref = jax_apply(jm, v, x, pos, deterministic=True, train=False)
    tm = load_converted(SetBlockStack(c, depth=2, num_heads=4,
                                      num_keypoints=4, range_window=8), v)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_keypoint_topk_breaks_ties_like_jax(rng):
    from partner_tpu_torch.models.set_transformer import (
        topk_lower_index_first)

    # mostly-zero saliency (non-maxima are zeroed), as in the keypoint init
    sal = np.where(rng.rand(6, 40) < 0.8, 0.0,
                   rng.randint(-2, 3, (6, 40))).astype(np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(sal), 4)
    out = topk_lower_index_first(torch.from_numpy(sal), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_rpn_matches_jax(rng):
    """Stride-2 explicit padding, the 1x1 upsample and the flipped
    ConvTranspose kernel."""
    from partner_tpu.models.rpn import RPN as JRPN
    from partner_tpu_torch.models.rpn import RPN

    kw = dict(layer_nums=(1, 2), ds_layer_strides=(1, 2),
              ds_num_filters=(8, 16), us_layer_strides=(1, 2),
              us_num_filters=(8, 8), num_input_features=6)
    x = rng.randn(2, 12, 10, 6).astype(np.float32)
    jm = JRPN(**kw)
    v = randomize(jax_init(jm, x, train=False), rng)
    ref = jax_apply(jm, v, x, train=False)
    tm = load_converted(RPN(**kw), v)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 12, 10, 16)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stats", ["unit", "eps-sized"])
def test_e2e_head_matches_jax(rng, stats):
    from partner_tpu.models.e2e_head import E2ESWVoteHead as JHead
    from partner_tpu_torch.models.e2e_head import E2ESWVoteHead

    grid, pr = (128, 128, 40), (0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0)
    kw = dict(in_channels=32, window_size=8, sl_depth=2, grid_size=grid,
              pc_range=pr, compute_dtype="float32")
    x = rng.randn(1, 16, 16, 32).astype(np.float32)
    jm = JHead(**kw)
    v = randomize(jax_init(jm, x, train=False), rng)
    if stats == "eps-sized":
        v = _small_var(v, rng)
    ref = jax_apply(jm, v, x, train=False)
    tm = load_converted(E2ESWVoteHead(**kw), v)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_layernorm_and_gelu_conventions(rng):
    """flax LayerNorm eps 1e-6 (torch: 1e-5) on a tiny-variance input, and
    the tanh GELU."""
    import flax.linen as fnn

    from partner_tpu_torch.models.layers import LayerNorm, gelu

    x = (rng.randn(4, 16) * 3e-3).astype(np.float32)
    ref = np.asarray(fnn.LayerNorm().apply({"params": {
        "scale": jnp.ones(16), "bias": jnp.zeros(16)}}, x))
    ln = LayerNorm(16)
    with torch.no_grad():
        out = ln(torch.from_numpy(x)).numpy()
    # elementwise f32 math (a 1e-5 eps would be off by ~50%)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    y = rng.randn(100).astype(np.float32) * 3
    np.testing.assert_allclose(
        gelu(torch.from_numpy(y)).numpy(),
        np.asarray(jax.nn.gelu(y, approximate=True)), rtol=1e-5, atol=1e-6)
