"""The pillar modules of partner_tpu_torch against the JAX package (CPU).

``DynamicPFNet`` in both point layouts and with each decoration flag
(``PillarFeatureNet`` its cuboid configuration), in eval and train mode:
the pooled features, the batch statistics of a train forward, and the
gradients of every parameter through ``jax.vjp``, on sweeps whose every
point is there twice, so that each pooled maximum is a tie between two
rows. ``PFNLayer`` and ``pp_scatter`` likewise. The pillar ids come from
the port's ``dynamic_voxelize`` at a capacity the sweep overflows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import randomize

torch.set_num_threads(2)

GRID = (32, 32, 1)
CAPACITY = 200       # the sweeps occupy 288 and 436 pillars
N_POINTS, N_ROWS = 2000, 2400
CUBOID_RANGE = (-20.0, -20.0, -2.0, 20.0, 20.0, 4.0)
CYLINDER_RANGE = (0.3, -np.pi, -2.0, 20.3, np.pi, 4.0)

# name -> (reader class, its kwargs); every flag on and off somewhere, the
# raz branch both with (cylinder-all) and without (cylinder-raz) xyz
CASES = {
    "cuboid-all": ("DynamicPFNet", dict(voxel_shape="cuboid",
                                        with_distance=True)),
    "cylinder-all": ("DynamicPFNet", dict(voxel_shape="cylinder",
                                          with_distance=True)),
    "cylinder-raz": ("DynamicPFNet", dict(voxel_shape="cylinder",
                                          xyz_cluster=False,
                                          xy_center=False)),
    "cuboid-ra": ("DynamicPFNet", dict(voxel_shape="cuboid",
                                       xyz_cluster=False, raz_cluster=False,
                                       xy_center=False, num_filters=(16,))),
    "pillar-feature-net": ("PillarFeatureNet", dict()),
}


def sweep(rng, layout):
    """(P, 7) points in ``layout`` and their mask: log-uniform range, a
    few beyond the grid, and the second half a shuffled copy of the first,
    so every point has a twin in its pillar."""
    half = N_POINTS // 2
    rho = np.exp(rng.uniform(np.log(0.4), np.log(24.0), half))
    phi = rng.uniform(-np.pi, np.pi, half)
    x, y = rho * np.cos(phi), rho * np.sin(phi)
    z = rng.uniform(-2.5, 4.5, half)
    i, e = rng.rand(half), rng.rand(half)
    cols = ([x, y, z, i, e, rho, phi] if layout == "cuboid"
            else [rho, phi, z, x, y, i, e])
    pts = np.stack(cols, 1).astype(np.float32)
    pts = np.concatenate([pts, pts[rng.permutation(half)]])
    out = np.zeros((N_ROWS, 7), np.float32)
    out[:N_POINTS] = pts
    out[N_POINTS:] = rng.randn(N_ROWS - N_POINTS, 7)   # masked garbage
    mask = np.zeros(N_ROWS, bool)
    mask[:N_POINTS] = True
    return out, mask


def pfn_inputs(layout, seed):
    """(points, mask, point_pillar, pillar coords, range, cell size)."""
    from partner_tpu_torch.ops.voxelize import dynamic_voxelize

    pr = CUBOID_RANGE if layout == "cuboid" else CYLINDER_RANGE
    vs = [(pr[3 + i] - pr[i]) / GRID[i] for i in range(3)]
    pts, mask = sweep(np.random.RandomState(seed), layout)
    vox = dynamic_voxelize(torch.from_numpy(pts)[None],
                           torch.from_numpy(mask)[None], vs, pr, GRID,
                           CAPACITY, return_point_voxel=True, features=False)
    assert bool(vox["mask"].all())     # overflowed: every slot taken
    return (pts, mask, vox["point_voxel"][0].numpy(),
            vox["coords"][0].numpy(), pr, vs)


@pytest.fixture(scope="module", params=list(CASES))
def pfn(request):
    """One case run in both packages from the same variables: eval
    output, train output, the batch statistics after the train forward
    and the parameters' gradients of ``sum(out * cot)``."""
    import partner_tpu.models.pillar as jpillar
    import partner_tpu_torch.models.pillar as tpillar
    from partner_tpu_torch.convert import flax_to_torch

    cls, kw = CASES[request.param]
    layout = kw.get("voxel_shape", "cuboid")
    pts, mask, pp, coords, pr, vs = pfn_inputs(layout, 3)
    kw = dict(kw, num_input_features=5, voxel_size=vs, pc_range=pr)
    kw.setdefault("num_filters", (16, 16))
    jm = getattr(jpillar, cls)(**kw)
    # device arrays: the cylinder layout indexes the points with one
    args = tuple(jnp.asarray(a) for a in (pts, mask, pp, coords)) + (
        CAPACITY,)
    rng = np.random.RandomState(4)
    variables = randomize(jm.init(jax.random.PRNGKey(0), *args, False), rng)
    cot = rng.randn(CAPACITY, kw["num_filters"][-1]).astype(np.float32)

    def train(params):
        return jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        *args, True, mutable=["batch_stats"])

    want_eval = np.asarray(jax.jit(
        lambda v: jm.apply(v, *args, False))(variables))
    want_train, vjp, stats = jax.vjp(train, variables["params"],
                                     has_aux=True)
    grads = vjp(jnp.asarray(cot))[0]

    tm = getattr(tpillar, cls)(**kw)
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    targs = [torch.from_numpy(a) for a in (pts, mask, pp, coords)]
    with torch.no_grad():
        got_eval = tm.eval()(*targs, CAPACITY).numpy()
    tm.train()
    got_train = tm(*targs, CAPACITY)
    (got_train * torch.from_numpy(cot)).sum().backward()
    tgrads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    tstats = {n: b.numpy() for n, b in tm.named_buffers()}
    return dict(
        want_eval=want_eval, got_eval=got_eval,
        want_train=np.asarray(want_train), got_train=got_train.detach()
        .numpy(), want_stats=flax_to_torch(jax.tree_util.tree_map(
            np.asarray, dict(stats))), got_stats=tstats,
        want_grads=flax_to_torch({"params": jax.tree_util.tree_map(
            np.asarray, grads)}), got_grads=tgrads, n_pillars=int(
            (pp < CAPACITY).sum()))


def _rel_ok(got, want, rtol):
    """Elementwise within ``rtol`` of the reference, with an absolute
    floor of ``rtol`` times the reference's largest value (a pooled 0 of
    one package may be a tiny positive of the other)."""
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_pfn_eval_forward_matches_jax(pfn):
    assert pfn["got_eval"].shape == pfn["want_eval"].shape
    assert np.abs(pfn["want_eval"]).max() > 0.1 and pfn["n_pillars"] > 400
    # f32 Dense and BatchNorm in another summation order
    _rel_ok(pfn["got_eval"], pfn["want_eval"], 1e-5)


def test_pfn_train_forward_and_statistics_match_jax(pfn):
    _rel_ok(pfn["got_train"], pfn["want_train"], 1e-5)
    assert sorted(pfn["got_stats"]) == sorted(pfn["want_stats"])
    for k, want in pfn["want_stats"].items():
        _rel_ok(pfn["got_stats"][k], want.numpy(), 1e-5)


def test_pfn_gradients_with_tied_maxima_match_jax(pfn):
    """Every pooled maximum is a tie of two equal rows: JAX's
    ``segment_max`` splits the cotangent evenly among them, and so must
    the port (not the flagship scatter-max's rule, which gives each
    winner all of it). Held per tensor: relative RMS <= 1e-4."""
    assert sorted(pfn["got_grads"]) == sorted(pfn["want_grads"])
    for k, want in pfn["want_grads"].items():
        want = want.numpy()
        got = pfn["got_grads"][k]
        assert np.linalg.norm(want) > 0, k
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-4, (k, rel)


def test_tied_rows_split_the_gradient_evenly():
    """Two equal rows at a pillar's maximum each take half its cotangent,
    as ``jax.vjp`` of ``segment_max`` gives them."""
    from partner_tpu_torch.models.pillar import _segment_max

    x = torch.tensor([[1.0], [3.0], [3.0], [2.0]], requires_grad=True)
    seg = torch.tensor([0, 0, 0, 1])
    _segment_max(x, seg, 3)[:2].sum().backward()
    want = jax.grad(lambda a: jax.ops.segment_max(
        a, jnp.asarray(seg.numpy()), num_segments=3)[:2].sum())(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy()[:, 0], [0, 0.5, 0.5, 1])


@pytest.mark.parametrize("train", [False, True])
def test_pfn_layer_matches_jax(train):
    from partner_tpu.models.readers import PFNLayer as JaxPFNLayer
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models.readers import PFNLayer

    rng = np.random.RandomState(5)
    x = rng.randn(600, 10).astype(np.float32)
    mask = rng.rand(600) > 0.3
    jm = JaxPFNLayer(features=24)
    v = randomize(jm.init(jax.random.PRNGKey(0), x, mask), rng)
    want = jm.apply(v, x, mask, train, mutable=["batch_stats"] if train
                    else False)
    want, stats = want if train else (want, None)
    tm = PFNLayer(10, 24)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    _rel_ok(got, np.asarray(want), 1e-5)
    assert not got[~mask].any()
    if train:
        for k, s in flax_to_torch(jax.tree_util.tree_map(
                np.asarray, dict(stats))).items():
            _rel_ok(dict(tm.named_buffers())[k].numpy(), s.numpy(), 1e-5)


def test_pp_scatter_matches_jax():
    """Bit-equal canvases at batch 2: each valid pillar's row at its
    cell, the masked pillars nowhere."""
    from partner_tpu.models.pillar import pp_scatter as jax_scatter
    from partner_tpu_torch.models.pillar import pp_scatter

    rng = np.random.RandomState(6)
    grid = (24, 40, 1)                      # n_r 24, n_az 40
    b, v, f = 2, 300, 5
    coords = np.zeros((b, v, 3), np.int32)
    for i in range(b):
        cells = rng.choice(grid[0] * grid[1], v, replace=False)
        coords[i, :, 1], coords[i, :, 2] = cells // grid[0], cells % grid[0]
    mask = rng.rand(b, v) > 0.25
    feats = rng.randn(b, v, f).astype(np.float32)
    want = np.asarray(jax.vmap(functools.partial(jax_scatter,
                                                 grid_size=grid))(
        feats, coords, mask))
    got = pp_scatter(torch.from_numpy(feats), torch.from_numpy(coords),
                     torch.from_numpy(mask), grid).numpy()
    assert got.shape == want.shape == (b, 40, 24, f)
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got.any(-1)) == int(mask.sum())
