"""The port's CSWin block (``models/cswin.py``) against flax (CPU):
``LePEAttention`` on row stripes, column stripes and square windows, with
and without the position bias, and ``CSWinBlock`` in both stage kinds,
with converted weights, within 1e-5; the stripe round trip; the converter
covering every parameter exactly."""

import numpy as np
import pytest
import torch

from torch_port_fixtures import randomize

torch.set_num_threads(2)

TOL = 1e-5   # float32 both sides, another summation order


def jax_init(module, rng, *args):
    import jax

    v = module.init(jax.random.PRNGKey(0), *args)
    # every weight moved off flax's init (LayerNorm scales and biases too)
    return randomize(jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.1, v), rng)


def converted(module, variables):
    from partner_tpu_torch.convert import flax_to_torch

    sd = flax_to_torch(variables)
    want = module.state_dict()
    # nothing missing, nothing unused, every shape equal
    assert sorted(sd) == sorted(want)
    for k, t in want.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
    module.load_state_dict(sd, strict=True)
    return module


def test_stripe_roundtrip(rng):
    from partner_tpu.models.cswin import _stripes as jstripes
    from partner_tpu_torch.models.cswin import _stripes, _unstripes

    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    t = torch.from_numpy(x)
    for h_sp, w_sp in [(1, 12), (8, 1), (4, 4), (2, 6)]:
        s = _stripes(t, h_sp, w_sp)
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(jstripes(x, h_sp, w_sp)))
        np.testing.assert_array_equal(
            _unstripes(s, h_sp, w_sp, 8, 12).numpy(), x)


@pytest.mark.parametrize("idx", [0, 1, -1])
@pytest.mark.parametrize("with_pos", [True, False], ids=["pos", "no-pos"])
def test_lepe_attention_matches_flax(rng, idx, with_pos):
    from partner_tpu.models.cswin import LePEAttention as JAttn
    from partner_tpu_torch.models.cswin import LePEAttention

    q, k, v = (rng.randn(2, 8, 12, 16).astype(np.float32) for _ in range(3))
    pos = (rng.randn(8, 12, 2) * 20).astype(np.float32)
    args = (q, k, v, pos) if with_pos else (q, k, v)
    jm = JAttn(idx=idx, num_heads=2, split_size=4)
    variables = jax_init(jm, rng, *args)
    want = np.asarray(jm.apply(variables, *args))
    tm = converted(LePEAttention(idx, 2, split_size=4, pos=with_pos),
                   variables)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("last_stage", [False, True],
                         ids=["rows-cols", "last-stage"])
@pytest.mark.parametrize("with_pos", [True, False], ids=["pos", "no-pos"])
def test_cswin_block_matches_flax(rng, last_stage, with_pos):
    from partner_tpu.models.cswin import CSWinBlock as JBlock
    from partner_tpu_torch.models.cswin import CSWinBlock

    x = rng.randn(2, 8, 16, 32).astype(np.float32)
    pos = (rng.randn(8, 16, 2) * 20).astype(np.float32)
    args = (x, pos) if with_pos else (x,)
    jm = JBlock(num_heads=4, split_size=4, last_stage=last_stage)
    variables = jax_init(jm, rng, *args)
    # a branch has parameters only where it has the position MLP
    branches = {"attn"} if last_stage else {"attn_row", "attn_col"}
    assert (branches <= set(variables["params"])) == with_pos
    want = np.asarray(jm.apply(variables, *args))
    tm = converted(CSWinBlock(32, 4, split_size=4, last_stage=last_stage,
                              pos=with_pos), variables)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(got - x).max() > 0.1      # the block did work
