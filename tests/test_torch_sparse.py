"""The sparse backbone of partner_tpu_torch against the JAX package (CPU).

Same numpy inputs, made from a seed, on both sides (the JAX functions run
per sample under ``jax.vmap``, the port's on the batch):

- both index methods' neighbour maps, ``downsample_coords`` and
  ``downsample_coords_dense`` (also at a capacity below the site count),
  and the strided maps: exactly equal;
- ``SparseConv`` and ``sparse_to_dense`` at rtol 1e-5;
- ``MaskedBatchNorm`` in eval and train mode: output, batch statistics,
  running update, masked rows at 0;
- ``SpMiddleResNetFHD``'s BEV at 1e-4 for both methods, batch 2 with
  unequal counts, and its train-mode gradients against ``jax.grad``;
- the row-order fault of JAX's ``"binary"`` method (ROADMAP.md §3): the
  port on permuted rows equals the port on sorted rows and JAX's
  ``"dense"`` method on the permuted rows, while JAX's ``"binary"``
  method differs there.
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_fixtures import randomize

torch.set_num_threads(2)

SHAPE = (7, 16, 12)          # (z, y, x): small, so rows sit on every face
GEOMS = {                    # (kernel, stride, padding) of the backbone
    "s2p1": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    "s2z0": ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    "extra": ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}
BB_INPUT = (16, 32, 24)      # (n_r, n_az, n_z): BEV 4 x 2 x 128


def sites(rng, shape, counts, n, sort=True):
    """(B, n, 3) int32 coords and (B, n) mask: counts[b] distinct cells
    (sorted by linear id unless ``sort`` is False), then padding rows with
    arbitrary coords."""
    total = int(np.prod(shape))
    b = len(counts)
    coords = rng.randint(0, 5, (b, n, 3)).astype(np.int32)
    mask = np.zeros((b, n), bool)
    for i, c in enumerate(counts):
        lin = rng.choice(total, c, replace=False)
        lin = np.sort(lin) if sort else lin
        z, rem = np.divmod(lin, shape[1] * shape[2])
        coords[i, :c] = np.stack([z, *np.divmod(rem, shape[2])], 1)
        mask[i, :c] = True
    return coords, mask


def permuted(rng, arrays, mask):
    """Each sample's rows shuffled, valid and padding rows mixed."""
    out = [a.copy() for a in arrays] + [mask.copy()]
    for i in range(mask.shape[0]):
        p = rng.permutation(mask.shape[1])
        for a in out:
            a[i] = a[i][p]
    return out


def t(a):
    return torch.from_numpy(np.array(a))


def jvmap(fn, *static):
    import jax

    return jax.jit(jax.vmap(lambda *a: fn(*a, *static)))


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "shuffled"])
def test_subm_neighbor_maps_match_jax(sort):
    from partner_tpu.models import sparse as js
    from partner_tpu_torch.models import sparse as ts

    rng = np.random.RandomState(0)
    coords, mask = sites(rng, SHAPE, (300, 170), 320, sort=sort)
    methods = [(js.build_subm_neighbor_map_dense,
                ts.build_subm_neighbor_map_dense)]
    if sort:     # the binary search needs the rows sorted by id
        methods.append((js.build_subm_neighbor_map,
                        ts.build_subm_neighbor_map))
    for jf, tf in methods:
        want = np.asarray(jvmap(jf, SHAPE)(coords, mask))
        got = tf(t(coords), t(mask), SHAPE).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=jf.__name__)
        assert (got < 320).sum() > 1000 and (got == 320).any()


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("cap", [320, 60], ids=["cap-all", "cap-below"])
def test_downsample_and_strided_maps_match_jax(geom, cap):
    import jax.numpy as jnp

    from partner_tpu.models import sparse as js
    from partner_tpu_torch.models import sparse as ts

    kernel, stride, padding = GEOMS[geom]
    rng = np.random.RandomState(1)
    coords, mask = sites(rng, SHAPE, (300, 170), 320)
    out_shape = js.strided_out_shape(SHAPE, kernel, stride, padding)
    assert ts.strided_out_shape(SHAPE, kernel, stride, padding) == out_shape
    geo = (kernel, stride, padding, cap)
    outs = {}
    for jf, tf in ((js.downsample_coords, ts.downsample_coords),
                   (js.downsample_coords_dense, ts.downsample_coords_dense)):
        wc, wm = jvmap(jf, SHAPE, *geo)(coords, mask)
        gc, gm = tf(t(coords), t(mask), SHAPE, *geo)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        assert gc.dtype == torch.int32
        outs[jf.__name__] = (np.asarray(wc), np.asarray(wm))
    oc, om = outs["downsample_coords"]
    np.testing.assert_array_equal(outs["downsample_coords_dense"][0], oc)
    if cap == 60:
        assert om.all()              # more sites than the capacity
    else:
        assert 0 < om[1].sum() < om[0].sum() < cap

    want = np.asarray(jvmap(
        lambda oc, om, ic, im: js.build_strided_neighbor_map(
            oc, om, out_shape, ic, im, SHAPE, kernel, stride, padding))(
        oc, om, coords, mask))
    got = ts.build_strided_neighbor_map(t(oc), t(om), out_shape, t(coords),
                                        t(mask), SHAPE, kernel, stride,
                                        padding).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 320).any()

    off = np.stack(np.meshgrid(*[np.arange(k) for k in kernel],
                               indexing="ij"), -1).reshape(-1, 3)

    def dense_map(oc, om, ic, im):
        table = js.build_index_table(ic, im, SHAPE)
        base = oc * jnp.asarray(stride) - jnp.asarray(padding)
        return js.lookup_neighbors(table, SHAPE, base, om,
                                   jnp.asarray(off, jnp.int32), 320)

    want_d = np.asarray(jvmap(dense_map)(oc, om, coords, mask))
    got_d = ts.build_strided_neighbor_map_dense(
        t(oc), t(om), t(coords), t(mask), SHAPE, kernel, stride, padding).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_d, want)


def test_index_table_and_lookup_match_jax():
    """The index table's every slot but the invalid rows' sentinel slot,
    and lookups of shuffled rows."""
    from partner_tpu.models import sparse as js
    from partner_tpu_torch.models import sparse as ts

    rng = np.random.RandomState(2)
    coords, mask = sites(rng, SHAPE, (250, 90), 256, sort=False)
    want = np.asarray(jvmap(js.build_index_table, SHAPE)(coords, mask))
    got = ts.build_index_table(t(coords), t(mask), SHAPE).numpy()
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])


def test_sparse_conv_and_to_dense_match_jax():
    import jax
    import jax.numpy as jnp

    from partner_tpu.models import sparse as js
    from partner_tpu_torch.models import sparse as ts

    rng = np.random.RandomState(3)
    coords, mask = sites(rng, SHAPE, (300, 170), 320)
    feats = rng.randn(2, 320, 8).astype(np.float32)
    nmap = np.asarray(jvmap(js.build_subm_neighbor_map, SHAPE)(coords, mask))
    for use_bias in (False, True):
        jm = js.SparseConv(16, use_bias=use_bias)
        v = jm.init(jax.random.PRNGKey(0), feats, nmap)
        v = randomize(v, rng)
        want = np.asarray(jax.jit(jm.apply)(v, feats, nmap))
        tm = ts.SparseConv(8, 16, use_bias=use_bias)
        tm.kernel.data = t(v["params"]["kernel"])
        if use_bias:
            tm.bias.data = t(v["params"]["bias"])
        with torch.no_grad():
            got = tm(t(feats), t(nmap)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    grid = js.SparseGrid(jnp.asarray(feats), jnp.asarray(coords),
                         jnp.asarray(mask), SHAPE)
    want = np.asarray(js.sparse_to_dense(grid))
    got = ts.sparse_to_dense(ts.SparseGrid(t(feats), t(coords), t(mask),
                                           SHAPE)).numpy()
    assert got.shape == want.shape == (2,) + SHAPE + (8,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.count_nonzero(got.any(-1)) == 470


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_masked_batch_norm_matches_jax(train):
    import jax

    from partner_tpu.models.layers import MaskedBatchNorm as JBN
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models.layers import MaskedBatchNorm

    rng = np.random.RandomState(4)
    x = (rng.randn(2, 64, 16) * 3 + 1).astype(np.float32)
    mask = rng.rand(2, 64) < 0.7
    jm = JBN(use_running_average=not train)
    v = randomize(jm.init(jax.random.PRNGKey(0), x, mask), rng)
    if train:
        want, upd = jax.jit(functools.partial(
            jm.apply, mutable=["batch_stats"]))(v, x, mask)
    else:
        want = jax.jit(jm.apply)(v, x, mask)
    tm = MaskedBatchNorm(16).train(train)
    sd = flax_to_torch({c: {"MaskedBatchNorm_0": v[c]} for c in v})
    assert sorted(sd) == [f"MaskedBatchNorm_0.{k}"
                          for k in ("bias", "mean", "scale", "var")]
    tm.load_state_dict({k.split(".")[1]: a for k, a in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(t(x), t(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got[~mask] == 0).all() and np.abs(got[mask]).min() >= 0
    if train:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(tm, k).numpy(), np.asarray(upd["batch_stats"][k]),
                rtol=1e-5, atol=1e-6, err_msg=k)
        m = mask[..., None]
        mean = (x * m).sum((0, 1)) / m.sum()
        var = ((x - mean) ** 2 * m).sum((0, 1)) / m.sum()
        np.testing.assert_allclose(
            tm.mean.numpy(), 0.99 * v["batch_stats"]["mean"] + 0.01 * mean,
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tm.var.numpy(), 0.99 * v["batch_stats"]["var"] + 0.01 * var,
            rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(tm.mean, t(v["batch_stats"]["mean"]))


def _backbone_case(seed, counts=(700, 430), n=800, sort=True):
    rng = np.random.RandomState(seed)
    n_r, n_az, n_z = BB_INPUT
    coords, mask = sites(rng, (n_z + 1, n_az, n_r), counts, n, sort=sort)
    feats = rng.rand(2, n, 5).astype(np.float32)
    return rng, feats, coords, mask


@functools.lru_cache(maxsize=None)
def _jax_backbone(method):
    """(flax module, randomized variables) of the JAX backbone."""
    import jax

    from partner_tpu.models.backbone import SpMiddleResNetFHD

    rng, feats, coords, mask = _backbone_case(5)
    jm = SpMiddleResNetFHD(num_input_features=5, index_method=method)
    v = jax.jit(functools.partial(jm.init, train=False), static_argnums=4)(
        jax.random.PRNGKey(0), feats, coords, mask, BB_INPUT)
    return jm, randomize(v, rng)


def _jax_bev(jm, v, feats, coords, mask):
    import jax

    bev, _ = jax.jit(functools.partial(jm.apply, train=False),
                     static_argnums=4)(v, feats, coords, mask, BB_INPUT)
    return np.asarray(bev)


def _port_backbone(v, method="binary"):
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models.backbone import SpMiddleResNetFHD

    tm = SpMiddleResNetFHD(num_input_features=5, index_method=method,
                           input_shape=BB_INPUT)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    assert tm.out_features == 128
    return tm.eval()


def _port_bev(tm, feats, coords, mask):
    with torch.no_grad():
        return tm(t(feats), t(coords), t(mask), BB_INPUT).numpy()


@pytest.mark.parametrize("method", ["binary", "dense"])
def test_backbone_bev_matches_jax(method):
    jm, v = _jax_backbone(method)
    _, feats, coords, mask = _backbone_case(6)
    want = _jax_bev(jm, v, feats, coords, mask)
    got = _port_bev(_port_backbone(v, method), feats, coords, mask)
    assert got.shape == want.shape == (2, 4, 2, 128)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_backbone_train_gradients_match_jax():
    """Train mode (batch statistics): the loss sum(bev * w) and its
    gradient with respect to every parameter and the input features,
    against ``jax.grad`` in float32."""
    import jax

    from partner_tpu_torch.convert import flax_to_torch

    jm, v = _jax_backbone("binary")
    rng, feats, coords, mask = _backbone_case(7)
    w = rng.randn(2, 4, 2, 128).astype(np.float32)

    def loss(params, x):
        bev, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          x, coords, mask, BB_INPUT, train=True,
                          mutable=["batch_stats"])[0]
        return (bev * w).sum()

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        v["params"], feats)
    tm = _port_backbone(v).train()
    x = t(feats).requires_grad_(True)
    tl = (tm(x, t(coords), t(mask), BB_INPUT) * t(w)).sum()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                           jgp)})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    top = max(float(g.abs().max()) for g in want.values())
    for n in want:
        if "SparseConv" in n and n.endswith(".bias"):
            # a bias ahead of a train-mode BatchNorm cancels in its mean:
            # the gradient is 0 up to rounding on both sides
            assert float(got[n].abs().max()) < 1e-6 * top, n
            assert float(want[n].abs().max()) < 1e-6 * top, n
            continue
        scale = float(want[n].abs().max())
        assert scale > 0, n
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   rtol=1e-3, atol=1e-4 * scale, err_msg=n)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=1e-3,
                               atol=1e-4 * float(np.abs(jgx).max()))


def test_first_come_rows_give_the_sorted_bev():
    """The row-order fault: hard voxels come in first-come order. The port
    sorts at entry, so its BEV on permuted rows equals its BEV on sorted
    rows, and JAX's "dense" method on the permuted rows; JAX's "binary"
    method, which assumes sorted rows, differs there."""
    jm_b, v = _jax_backbone("binary")
    jm_d, _ = _jax_backbone("dense")
    rng, feats, coords, mask = _backbone_case(8)
    pf, pc, pm = permuted(rng, [feats, coords], mask)
    tm = _port_backbone(v)
    sorted_bev = _port_bev(tm, feats, coords, mask)
    np.testing.assert_array_equal(_port_bev(tm, pf, pc, pm), sorted_bev)
    np.testing.assert_array_equal(
        _port_bev(_port_backbone(v, "dense"), pf, pc, pm), sorted_bev)
    dense_bev = _jax_bev(jm_d, v, pf, pc, pm)
    np.testing.assert_allclose(sorted_bev, dense_bev, rtol=1e-4, atol=1e-4)
    binary_bev = _jax_bev(jm_b, v, pf, pc, pm)
    assert np.abs(binary_bev - dense_bev).max() > 1e-2   # JAX's fault
