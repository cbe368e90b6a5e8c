"""The port's native host library (``partner_tpu_torch/native``) against its
numpy bodies and the JAX package's library (``partner_tpu.native``).

The port keeps its own copy of ``partner_native.cpp`` and builds it with
``g++`` at first use. Its three functions must equal the numpy bodies the
data path falls back to, and the JAX package's library, bit for bit, on
inputs made from a seed (after ``tests/test_native.py``): the hard
voxelizer with heavy capping and out-of-range points, the collision test,
and points in 7- and 9-column boxes. The dispatchers take the library
where it is built and the numpy bodies inside ``numpy_only``; a train
batch with GT-AUG is the same either way; and a failed build logs the
compiler's stderr and leaves the numpy bodies running.
"""

import copy
import logging

import numpy as np
import pytest

from partner_tpu import native as jnative
from partner_tpu_torch import native

VS = np.array([0.3, 0.02, 0.2], np.float32)
PR = np.array([0.0, -np.pi, -2.0, 75.0, np.pi, 4.0], np.float32)


def test_library_builds_here():
    """g++ is on this host, so the port's library builds and runs."""
    assert native.available()
    assert jnative.available()


def _cloud(rng, n=5000, c=5):
    pts = np.empty((n, c), np.float32)
    pts[:, 0] = rng.uniform(0.5, 74.5, n)       # rho
    pts[:, 1] = rng.uniform(-np.pi, np.pi, n)   # phi
    pts[:, 2] = rng.uniform(-1.9, 3.9, n)       # z
    pts[:, 3:] = rng.rand(n, c - 3)
    return pts


def _out_of_range(rng):
    pts = _cloud(rng, n=3000)
    pts[::7, 0] = 200.0    # beyond the rho range
    pts[::11, 2] = -50.0   # below the z range
    pts[::13, 1] = -4.0    # before the azimuth range
    return pts


VOXEL_CASES = {
    "flagship-5x100000": (lambda r: _cloud(r), VS, 5, 100000),
    "capacity-64": (lambda r: _cloud(r), VS, 3, 64),
    "one-point-4000": (lambda r: _cloud(r), VS, 1, 4000),
    "dense-collisions": (lambda r: _cloud(r, n=20000),
                         np.array([5.0, 0.5, 1.0], np.float32), 8, 500),
    "out-of-range": (_out_of_range, VS, 5, 10000),
}


@pytest.mark.parametrize("case", list(VOXEL_CASES))
def test_points_to_voxel_bit_equal(case):
    from partner_tpu_torch.ops.voxelize import points_to_voxel

    make, vs, max_points, max_voxels = VOXEL_CASES[case]
    pts = make(np.random.RandomState(0))
    want = points_to_voxel(pts, vs, PR, max_points, max_voxels)
    got = native.points_to_voxel(pts, vs, PR, max_points, max_voxels)
    ref = jnative.points_to_voxel(pts, vs, PR, max_points, max_voxels)
    for w, g, r in zip(want, got, ref):
        assert g.dtype == w.dtype == r.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    if case == "dense-collisions":
        assert (got[2] == max_points).mean() > 0.5    # capped voxels


def test_points_to_voxel_at_cell_edges():
    """Points within a rounding of a cell edge, where float32
    ``(p - lo) * (1 / size)`` floors into the cell below ``(p - lo) /
    size``: the port's library divides, as the numpy body and
    ``dynamic_voxelize`` do, and keeps every point in the numpy body's
    cell. (The JAX package's library multiplies by the reciprocal there.)"""
    from partner_tpu_torch.ops.voxelize import points_to_voxel

    pr = np.array([0.3, -np.pi, -2.0, 75.18, np.pi, 4.0], np.float32)
    vs = ((pr[3:] - pr[:3]) / np.array([1152, 2048, 40])).astype(np.float32)
    edges = pr[0] + np.arange(1, 1152, dtype=np.float32) * vs[0]
    rho = np.concatenate([edges, np.nextafter(edges, np.float32(-1e9))])
    rho = rho.astype(np.float32)
    down = np.floor((rho - pr[0]) * (np.float32(1) / vs[0]))
    assert (down != np.floor((rho - pr[0]) / vs[0])).sum() > 10
    pts = np.zeros((len(rho), 5), np.float32)
    pts[:, 0] = rho
    pts[:, 1] = np.linspace(-3.0, 3.0, len(rho), dtype=np.float32)
    want = points_to_voxel(pts, vs, pr, 5, 100000)
    got = native.points_to_voxel(pts, vs, pr, 5, 100000)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _corners(rng, n, spread):
    from partner_tpu_torch.core import box_np_ops

    b = np.stack([rng.uniform(-spread, spread, n),
                  rng.uniform(-spread, spread, n), rng.uniform(1, 6, n),
                  rng.uniform(1, 3, n), rng.uniform(-np.pi, np.pi, n)], 1)
    return box_np_ops.center_to_corner_box2d(b[:, :2], b[:, 2:4],
                                             b[:, 4]).astype(np.float32)


@pytest.mark.parametrize("spread", [20.0, 4.0])
def test_box_collision_bit_equal(spread):
    from partner_tpu_torch.data.augment import box_collision_test_np

    rng = np.random.RandomState(1)
    ca, cb = _corners(rng, 40, spread), _corners(rng, 30, spread)
    got = native.box_collision_test(ca, cb)
    np.testing.assert_array_equal(got, box_collision_test_np(ca, cb))
    np.testing.assert_array_equal(got, jnative.box_collision_test(ca, cb))
    assert 0 < got.sum() < got.size
    assert native.box_collision_test(ca[:0], cb).shape == (0, 30)


def test_box_collision_known_cases():
    sq = np.array([[[0, 0], [1, 0], [1, 1], [0, 1]]], np.float32)
    far = sq + np.array([5.0, 0.0], np.float32)
    touch = sq + np.array([1.0 + 1e-3, 0.0], np.float32)
    overlap = sq + np.array([0.5, 0.5], np.float32)
    assert not native.box_collision_test(sq, far)[0, 0]
    assert not native.box_collision_test(sq, touch)[0, 0]
    assert native.box_collision_test(sq, overlap)[0, 0]


def _boxes(rng, k, ncol):
    b = np.stack([rng.uniform(-20, 20, k), rng.uniform(-20, 20, k),
                  rng.uniform(-1, 1, k), rng.uniform(2, 6, k),
                  rng.uniform(1, 3, k), rng.uniform(1, 2, k),
                  rng.uniform(-np.pi, np.pi, k)], 1).astype(np.float32)
    if ncol == 9:   # velocity columns before the yaw
        b = np.concatenate([b[:, :6], rng.randn(k, 2).astype(np.float32),
                            b[:, 6:]], 1)
    return b


@pytest.mark.parametrize("ncol", [7, 9])
def test_points_in_rbbox_bit_equal(ncol):
    """Bit-equal to the JAX library and to the numpy body on this seeded
    input. (The library rotates in double where the numpy body rotates in
    float32, so a point within a float32 rounding of a box face could
    fall on either side; none does here.)"""
    from partner_tpu_torch.core import box_np_ops

    rng = np.random.RandomState(2)
    pts = rng.uniform(-30, 30, (4000, 5)).astype(np.float32)
    boxes = _boxes(rng, 12, ncol)
    got = native.points_in_rbbox(pts, boxes)
    np.testing.assert_array_equal(got, jnative.points_in_rbbox(pts, boxes))
    want = box_np_ops.points_in_rbbox_np(pts, boxes)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum()
    if ncol == 9:   # the yaw is read from the last column
        seven = np.concatenate([boxes[:, :6], boxes[:, -1:]], 1)
        np.testing.assert_array_equal(got, native.points_in_rbbox(pts,
                                                                  seven))


def test_dispatchers_take_the_library_and_numpy_only():
    from partner_tpu_torch.core import box_np_ops
    from partner_tpu_torch.data import augment
    from partner_tpu_torch.ops.voxelize import VoxelGenerator

    rng = np.random.RandomState(3)
    pts = _cloud(rng, 2000)
    gen = VoxelGenerator(VS, PR, 5, 1000)
    ca = _corners(rng, 20, 6.0)
    boxes = _boxes(rng, 6, 7)
    calls = []

    def spy(name):
        fn = getattr(native, name)

        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped

    mp = pytest.MonkeyPatch()
    for name in ("points_to_voxel", "box_collision_test", "points_in_rbbox"):
        mp.setattr(native, name, spy(name))
    try:
        lib = (gen.generate(pts), augment.box_collision_test(ca, ca),
               box_np_ops.points_in_rbbox(pts[:, :3], boxes))
        assert calls == ["points_to_voxel", "box_collision_test",
                         "points_in_rbbox"]
        with native.numpy_only():
            assert not native.available()
            body = (gen.generate(pts), augment.box_collision_test(ca, ca),
                    box_np_ops.points_in_rbbox(pts[:, :3], boxes))
        assert native.available() and len(calls) == 3
    finally:
        mp.undo()
    for a, b in zip(lib[0], body[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lib[1], body[1])
    np.testing.assert_array_equal(lib[2], body[2])


def test_train_batches_equal_with_and_without_the_library(tmp_path):
    """The flagship train_pipeline with GT-AUG (the collision test at every
    sample) gives the same items with the library and without it."""
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.collate import collate
    from test_torch_train_data import (TARGET_KEYS, flagship_train_cfg,
                                       write_infos_and_db)

    info_path, db_path = write_infos_and_db(tmp_path)
    train = flagship_train_cfg(info_path, str(tmp_path), db_path)
    batches = []
    for use_lib in (True, False):
        ds = tdata.build_dataset(copy.deepcopy(train),
                                 dict(rng=np.random.RandomState(21)))
        if use_lib:
            items = [ds[i] for i in range(len(ds))]
        else:
            with native.numpy_only():
                items = [ds[i] for i in range(len(ds))]
        batches.append(collate(items, max_points=8000))
    a, b = batches
    assert sorted(a) == sorted(b)
    for k in ("points", "points_mask") + TARGET_KEYS:
        for x, y in (zip(a[k], b[k]) if isinstance(a[k], list)
                     else [(a[k], b[k])]):
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_failed_build_logs_stderr_and_runs_numpy(tmp_path, caplog):
    """A source g++ refuses: one warning with the compiler's stderr,
    ``available()`` False, and the dispatchers on the numpy bodies."""
    from partner_tpu_torch.data import augment

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "SRC", str(bad))
    mp.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    mp.setattr(native, "_LIB", None)
    mp.setattr(native, "_TRIED", False)
    try:
        with caplog.at_level(logging.WARNING, logger=native.__name__):
            assert not native.available()
            assert not native.available()
            ca = _corners(np.random.RandomState(4), 10, 4.0)
            np.testing.assert_array_equal(
                augment.box_collision_test(ca, ca),
                augment.box_collision_test_np(ca, ca))
        warnings = [r for r in caplog.records if r.name == native.__name__]
        assert len(warnings) == 1
        assert "g++ failed" in warnings[0].getMessage()
        assert "bad.cpp" in warnings[0].getMessage()   # the stderr
        with pytest.raises(RuntimeError, match="not available"):
            native.box_collision_test(ca, ca)
    finally:
        mp.undo()
    assert native.available()
