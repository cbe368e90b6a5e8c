"""The polar ego-motion warp of partner_tpu_torch (``ops/warp.py``) against
the JAX package's ``partner_tpu/ops/warp.py`` (CPU, float32).

``ego_motion_warp_polar`` resamples a (B, n_az, n_r, C) polar map at the
current grid's cell centres moved by a current -> previous transform:
JAX's ``map_coordinates(order=1, mode="constant")``, whose out-of-range
corners count 0 each, the azimuth wrapped by a floor modulo over one
appended wrap row, the radial range masked after. Held here: the cell
centres and ``make_bev_transform`` equal; the identity, a pure rotation
and a random transform (samples across the +-pi seam and beyond the
radial range) within ``WARP_TOL`` of JAX and zeroed at the same cells;
JAX's corner rule on a map of ones, along the radial axis; a turn by one
azimuth cell as a roll of the map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# the sample coordinates go through float32 cos / sin / atan2 / hypot,
# which XLA and torch round apart by an ulp: a coordinate of ~30 cells
# moves by ~4e-6 cells, times the map's step from cell to cell (up to ~5
# for unit normal maps). Measured within 1.7e-5.
WARP_TOL = 3e-5
PC_RANGE = np.float32([2.0, -np.pi, -5.0, 50.0, np.pi, 3.0])
SHAPE = (2, 32, 16, 5)     # (B, n_az, n_r, C)
MOTIONS = {"identity": ([0, 0], [0, 0], [0, 0]),
           "rotation": ([0, 0], [0, 0], [0.3, -0.7]),
           "random": ([4.0, -6.5], [-3.0, 2.5], [0.7, -2.9])}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _transforms(name):
    from partner_tpu.ops.warp import make_bev_transform

    dx, dy, dth = (np.float32(v) for v in MOTIONS[name])
    return np.asarray(make_bev_transform(jnp.asarray(dx), jnp.asarray(dy),
                                         jnp.asarray(dth)))


def test_cell_centers_and_transform_match_jax():
    """``polar_cell_centers`` bit-equal to JAX's on a float32 range, and
    ``make_bev_transform`` of the random motion within 1e-7 (one float32
    cos and one sin per sample on each side)."""
    from partner_tpu.ops import warp as jw
    from partner_tpu_torch.ops import warp as tw

    want = jw.polar_cell_centers(32, 16, jnp.asarray(PC_RANGE))
    got = tw.polar_cell_centers(32, 16, PC_RANGE)
    for g, w in zip(got, want):
        assert g.shape == (32, 16)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dx, dy, dth = (np.float32(v) for v in MOTIONS["random"])
    np.testing.assert_allclose(
        tw.make_bev_transform(t(dx), t(dy), t(dth)).numpy(),
        _transforms("random"), rtol=0, atol=1e-7)


@pytest.mark.parametrize("motion", list(MOTIONS))
def test_warp_matches_jax(motion):
    """The warp of a unit normal map within ``WARP_TOL`` of JAX's, the
    same cells zeroed (sources beyond [r0, r1]); the random motion sends
    samples across the seam (a source azimuth cell coordinate within half
    a cell of +-pi) and out of the radial range, and the identity gives
    the map back within the same bound."""
    from partner_tpu.ops.warp import ego_motion_warp_polar as jwarp
    from partner_tpu_torch.ops.warp import ego_motion_warp_polar

    f = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    tf = _transforms(motion)
    want = np.asarray(jax.jit(lambda f, tf: jwarp(
        f, tf, jnp.asarray(PC_RANGE)))(f, tf))
    got = ego_motion_warp_polar(t(f), t(tf), PC_RANGE).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_TOL)
    zero = (want == 0).all(-1)
    np.testing.assert_array_equal((got == 0).all(-1), zero)
    if motion == "identity":
        np.testing.assert_allclose(got, f, rtol=0, atol=WARP_TOL)
        assert not zero.any()
    if motion == "random":
        assert 0 < zero[0].sum() < zero[0].size   # beyond the radial range
        # the seam: some source azimuths lie in the last half cell or the
        # first, where the wrap row is read
        from partner_tpu_torch.ops.warp import polar_cell_centers

        rho, phi = polar_cell_centers(SHAPE[1], SHAPE[2], PC_RANGE)
        x, y = rho * torch.cos(phi), rho * torch.sin(phi)
        m = t(tf)[0]
        px = m[0, 0] * x + m[0, 1] * y + m[0, 2]
        py = m[1, 0] * x + m[1, 1] * y + m[1, 2]
        gp = ((torch.atan2(py, px) + np.pi) / (2 * np.pi) * SHAPE[1] - 0.5)
        assert bool(((gp < 0) | (gp > SHAPE[1] - 1)).any())


@pytest.mark.parametrize(
    "shift", [(1.3, 0.0), (-0.9, 1.1), (2.6, -2.2), (0.0, -1.7)],
    ids=["ahead", "diagonal", "far", "sideways"])
def test_out_of_range_corners_count_zero_each(shift):
    """JAX's constant mode zeroes each out-of-range corner, not the whole
    sample: ``map_coordinates`` of ones(3) gives 0.5 at -0.5 and 2.5 and 0
    at -1 and 3. So a source less than half a cell inside r0 (radial cell
    coordinate ``gr`` in (-0.5, 0)) reads its r0 - 1 corner as 0 while
    the radial mask keeps the cell: the warp of a map of ones by an ego
    translation reads ``1 + gr`` there and ``n_r - gr`` half a cell inside
    r1, 1 elsewhere in range and 0 outside, in both packages."""
    from partner_tpu.ops.warp import ego_motion_warp_polar as jwarp
    from partner_tpu_torch.ops.warp import (ego_motion_warp_polar,
                                            polar_cell_centers)

    got = np.asarray(jax.scipy.ndimage.map_coordinates(
        jnp.ones(3), [jnp.float32([-0.5, 2.5, -1.0, 3.0])], order=1,
        mode="constant"))
    np.testing.assert_array_equal(got, [0.5, 0.5, 0.0, 0.0])
    n_az, n_r = SHAPE[1], SHAPE[2]
    f = np.ones((1, n_az, n_r, 1), np.float32)
    tf = np.float32([[[1, 0, shift[0]], [0, 1, shift[1]], [0, 0, 1]]])
    w = np.asarray(jwarp(f, tf, jnp.asarray(PC_RANGE)))[0, ..., 0]
    g = ego_motion_warp_polar(t(f), t(tf), PC_RANGE).numpy()[0, ..., 0]
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    rho, phi = polar_cell_centers(n_az, n_r, PC_RANGE)
    src = torch.hypot(rho * torch.cos(phi) + shift[0],
                      rho * torch.sin(phi) + shift[1]).numpy()
    r0, r1 = float(PC_RANGE[0]), float(PC_RANGE[3])
    gr = (src - r0) / (r1 - r0) * n_r - 0.5
    inner = (src >= r0) & (gr < 0)
    outer = (src <= r1) & (gr > n_r - 1)
    assert inner.any() and outer.any()
    want = np.where((src < r0) | (src > r1), 0.0, 1.0)
    want = np.where(inner, 1 + gr, np.where(outer, n_r - gr, want))
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-5)
    assert ((g[inner] > 0.5 - 1e-5) & (g[inner] < 1)).all()


def test_turn_by_one_cell_rolls_the_map():
    """A pure turn of the ego by one azimuth cell reads each cell from its
    neighbour: the warp is the map rolled by one row (the wrap row closing
    the seam), within ``WARP_TOL``, in both packages."""
    from partner_tpu.ops.warp import ego_motion_warp_polar as jwarp
    from partner_tpu_torch.ops.warp import ego_motion_warp_polar

    f = np.random.RandomState(1).randn(1, 32, 16, 3).astype(np.float32)
    cell = 2 * np.pi / 32
    c, s = np.cos(cell), np.sin(cell)
    tf = np.float32([[[c, -s, 0], [s, c, 0], [0, 0, 1]]])
    want = np.roll(f, -1, axis=1)
    got = ego_motion_warp_polar(t(f), t(tf), PC_RANGE).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_TOL)
    np.testing.assert_allclose(
        np.asarray(jwarp(f, tf, jnp.asarray(PC_RANGE))), want, rtol=0,
        atol=WARP_TOL)
