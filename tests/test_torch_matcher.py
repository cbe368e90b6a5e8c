"""The auction matcher of partner_tpu_torch against the JAX package (CPU):
the same assignment on random and tied benefits, with fewer queries than
candidates and with masked gts, the scipy optimum on small dense cases,
and the same result whatever the rounds between two exit checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _jax_auction(vals, idx, mask, n):
    from partner_tpu.losses.matcher import auction_assign

    return np.asarray(jax.jit(jax.vmap(
        lambda v, i, m: auction_assign(v, i, m, n)))(vals, idx, mask))


def _candidates(rng, b, m, n, c, ties):
    """(B, M, C) candidate benefits and query ids, as ``_topc_candidates``
    gives them; ``ties`` quantizes benefits to a few values, so that equal
    values, equal bids and shared first choices are common."""
    from partner_tpu_torch.losses.matcher import _topc_candidates

    benefit = rng.rand(b, m, n).astype(np.float32)
    if ties:
        benefit = np.round(benefit * 4) / 4
    vals, idx = _topc_candidates(torch.from_numpy(benefit), c)
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("case", [
    dict(m=8, n=40, c=6, ties=False),
    dict(m=8, n=40, c=6, ties=True),
    dict(m=12, n=10, c=32, ties=True),     # fewer queries than candidates
    dict(m=6, n=30, c=4, ties=True, masked="all"),
    dict(m=10, n=30, c=5, ties=False, masked="some"),
], ids=["random", "ties", "few-queries", "all-masked", "some-masked"])
def test_auction_assign_matches_jax(rng, case):
    from partner_tpu_torch.losses.matcher import auction_assign

    b, m, n, c = 3, case["m"], case["n"], case["c"]
    vals, idx = _candidates(rng, b, m, n, c, case["ties"])
    mask = np.ones((b, m), bool)
    if case.get("masked") == "all":
        mask[:] = False
    elif case.get("masked") == "some":
        mask = rng.rand(b, m) < 0.6
    ref = _jax_auction(vals, idx.astype(np.int32), mask, n)
    got = auction_assign(torch.from_numpy(vals), torch.from_numpy(idx),
                         torch.from_numpy(mask), n).numpy()
    # the same bids, prices and tie rules: equal assignments
    np.testing.assert_array_equal(got, ref)
    assert (got[~mask] == -1).all()
    if case.get("masked") != "all":
        assert (got >= 0).any()


def test_topc_candidates_break_ties_like_top_k(rng):
    from partner_tpu_torch.losses.matcher import _topc_candidates

    benefit = np.round(rng.rand(4, 5, 50) * 3).astype(np.float32) / 3
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(benefit), 7)
    vals, idx = _topc_candidates(torch.from_numpy(benefit), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    # a budget above the query count keeps every query
    assert _topc_candidates(torch.from_numpy(benefit), 80)[1].shape[-1] == 50


def _head_case(rng, b, n, m, ncls=1):
    logits = rng.randn(b, n, ncls).astype(np.float32)
    boxes = rng.randn(b, n, 8).astype(np.float32)
    enc = rng.randn(b, m, 8).astype(np.float32)
    near = rng.randint(0, n, (b, m))
    for i in range(b):                   # a few close queries per gt
        boxes[i, near[i]] = enc[i] + 0.1 * rng.randn(m, 8)
    classes = rng.randint(0, ncls, (b, m)).astype(np.int32)
    mask = rng.rand(b, m) < 0.8
    return logits, boxes, classes, enc, mask, np.ones(8, np.float32)


def test_assign_auction_matches_jax_end_to_end(rng):
    from partner_tpu.losses import matcher as jm
    from partner_tpu_torch.losses import matcher

    args = _head_case(rng, b=3, n=200, m=16, ncls=2)
    ref = np.asarray(jm.assign_auction(*args))
    got = matcher.assign_auction(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the benefit itself, elementwise (pow, exp, sigmoid in f32)
    jb = jax.vmap(jm.matching_benefit, in_axes=(0, 0, 0, 0, 0, None))(*args)
    tb = matcher.matching_benefit(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-7)


def test_auction_reaches_the_scipy_optimum_on_small_dense_cases(rng):
    """With every query a candidate and benefit gaps far above the
    auction's eps (1e-4), the auction's assignment is the Hungarian
    optimum."""
    from partner_tpu_torch.losses import matcher

    for trial in range(5):
        args = [torch.from_numpy(a) for a in _head_case(rng, 2, 12, 5)]
        args[4][:] = True
        auction = matcher.assign_auction(*args, num_candidates=12)
        optimum = matcher.assign_scipy(*args)
        np.testing.assert_array_equal(auction.numpy(), optimum.numpy())


def test_chunked_exit_check_gives_the_same_assignment(rng):
    """Once no gt of a scene is open, a round changes nothing, so checking
    the exit every k rounds gives the same result for every k."""
    from partner_tpu_torch.losses.matcher import auction_assign

    vals, idx = _candidates(rng, 4, 12, 10, 8, ties=True)
    mask = rng.rand(4, 12) < 0.9
    args = (torch.from_numpy(vals), torch.from_numpy(idx),
            torch.from_numpy(mask), 10)
    results = [auction_assign(*args, check_every=k).numpy()
               for k in (1, 7, 32, 3000)]
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
