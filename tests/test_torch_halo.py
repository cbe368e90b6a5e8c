"""The azimuth ring halo of partner_tpu_torch (``parallel/halo.py``) and
``RPNHalo(axis_name=...)`` on two gloo ranks of the CPU, against the JAX
package's ``shard_map`` forms on two of conftest's virtual CPU devices
(``tests/test_streaming.py:33-70``): each rank holds one azimuth shard,
in rank order, as each device holds one under ``P(None, "azimuth")``.

Forward and gradients: the halo functions move values and their
cotangents, so they are exact; the neck (eval mode, randomized weights)
holds its outputs and gradients at ``TOL`` (float32 convs in two
summation orders), its parameter gradients summed over the ranks as JAX
sums them over the shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_cases as tdc
from torch_port_fixtures import drawn_init, load_converted, randomize

torch.set_num_threads(2)

NECK = dict(layer_nums=(1, 1), ds_layer_strides=(1, 2),
            ds_num_filters=(16, 32), us_layer_strides=(1, 2),
            us_num_filters=(16, 16), num_input_features=16)
TOL = dict(rtol=1e-4, atol=1e-5)
PADS = {"ring": 2, "trailing": 1}
AZ = P(None, "azimuth", None, None)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("azimuth",))


def _sharded(fn):
    return shard_map(fn, mesh=_mesh(), in_specs=AZ, out_specs=AZ,
                     check_rep=False)


@pytest.fixture(scope="module")
def halo_runs(tmp_path_factory):
    """The two ranks' halos and neck, and the JAX shard_map references
    with their gradients."""
    from partner_tpu.models.rpn_stream import RPNHalo
    from partner_tpu.parallel.halo import ring_halo, trailing_halo
    from partner_tpu_torch.models.rpn_stream import RPNHalo as TorchHalo

    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 4, 3).astype(np.float32)
    task = dict(kind="halo", name="halo", x=x, pads=PADS)
    ref = {}
    for key, fn in (("ring", ring_halo), ("trailing", trailing_halo)):
        pad = PADS[key]
        f = _sharded(lambda xs, fn=fn, pad=pad: fn(xs, pad, "azimuth",
                                                   axis=1))
        y = jax.jit(f)(jnp.asarray(x))
        cot = rng.randn(*y.shape).astype(np.float32)
        gx = jax.jit(jax.grad(lambda xx: jnp.sum(f(xx) * cot)))(
            jnp.asarray(x))
        task[key + "_cot"] = cot
        ref[key] = (np.asarray(y), np.asarray(gx))

    jneck = RPNHalo(**NECK)
    jsharded = RPNHalo(axis_name="azimuth", **NECK)
    xn = rng.randn(1, 32, 16, 16).astype(np.float32)
    v = randomize(drawn_init(jneck.init, rng, xn, train=False), rng)
    fx = lambda xs, params: shard_map(
        lambda a: jsharded.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, a,
                                 train=False),
        mesh=_mesh(), in_specs=AZ, out_specs=AZ, check_rep=False)(xs)
    y = jax.jit(fx)(jnp.asarray(xn), v["params"])
    cot = rng.randn(*y.shape).astype(np.float32)
    gx, gp = jax.jit(jax.grad(lambda xx, pp: jnp.sum(fx(xx, pp) * cot),
                              argnums=(0, 1)))(jnp.asarray(xn), v["params"])
    whole = jax.jit(lambda vv, xx: jneck.apply(vv, xx, train=False))(
        v, jnp.asarray(xn))
    tneck = load_converted(TorchHalo(**NECK), v)
    task.update(neck=dict(NECK, type="RPNHalo"),
                neck_state=tneck.state_dict(), neck_x=xn, neck_cot=cot)
    ref["neck"] = (np.asarray(y), np.asarray(gx), gp, np.asarray(whole))
    two = tdc.collect(tdc.start([task], str(tmp_path_factory.mktemp(
        "halo"))))["halo"]
    return two, ref, task


def _cat(two, key, field):
    return torch.cat([two[r][key][field] for r in range(2)], dim=1).numpy()


@pytest.mark.parametrize("key", ["ring", "trailing"])
def test_halo_matches_jax_shard_map(halo_runs, key):
    """``ring_halo`` (pad 2: each shard gains its neighbours' rows, the ring
    closing from the last shard to the first) and ``trailing_halo`` (pad
    1: the previous shard's trailing rows, zeros on shard 0, zero rows
    appended), each rank's output and the cotangent sent back to the rank
    whose rows padded a neighbour: bit-equal to JAX's."""
    two, ref, _ = halo_runs
    y, gx = ref[key]
    np.testing.assert_array_equal(_cat(two, key, "y"), y)
    np.testing.assert_array_equal(_cat(two, key, "x_grad"), gx)


def test_single_shard_halo_is_circular_padding():
    """Without a group the ring halo is circular padding and the trailing
    halo pads zeros on both sides, as one shard of JAX's."""
    from partner_tpu.parallel.halo import ring_halo as jring
    from partner_tpu.parallel.halo import trailing_halo as jtrail
    from partner_tpu_torch.parallel.halo import ring_halo, trailing_halo

    x = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("azimuth",))
    for fn, jfn in ((ring_halo, jring), (trailing_halo, jtrail)):
        want = shard_map(lambda a: jfn(a, 2, "azimuth", axis=1), mesh=mesh,
                         in_specs=AZ, out_specs=AZ, check_rep=False)(x)
        got = fn(torch.from_numpy(x), 2, None, axis=1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rpn_halo_on_the_mesh_axis_matches_jax(halo_runs):
    """``RPNHalo(axis_name="azimuth")`` over two ranks (16 azimuth rows
    each; the stride-2 scale 8) against JAX's ``shard_map`` form and the
    whole sweep's neck: outputs, input gradients, and the parameter
    gradients summed over the ranks."""
    from partner_tpu_torch.convert import flax_to_torch

    two, ref, _ = halo_runs
    y, gx, gp, whole = ref["neck"]
    np.testing.assert_allclose(_cat(two, "neck", "y"), y, **TOL)
    np.testing.assert_allclose(y, whole, **TOL)
    np.testing.assert_allclose(_cat(two, "neck", "x_grad"), gx, **TOL)
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, gp)})
    got = {k: sum(two[r]["neck"]["param_grads"][k] for r in range(2))
           for k in two[0]["neck"]["param_grads"]}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   err_msg=k)
