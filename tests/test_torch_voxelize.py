"""The voxel-input contract of partner_tpu_torch against the JAX package (CPU).

Same numpy inputs, made from a seed, on both sides:

- ``ops.voxelize.dynamic_voxelize`` (torch, batched) against JAX's jitted
  ``dynamic_voxelize`` per sample: coords, mask, counts and point slots
  exact, features to 1e-6 relative (bit-equal where the stable sort keeps
  JAX's summation order), at capacity overflow, all points out of range,
  an empty cloud, the azimuth wrap and many points a voxel;
- ``points_to_voxel`` and ``VoxelGenerator`` exact;
- the readers, and ``PolarDenseFHD.forward`` on voxels against JAX
  ``__call__`` (float32, tiny grid, 2D and 3D trunks);
- the tiny frames through ``features`` and through ``voxels``: PARTNER on
  both head routes, CenterPoint one- and two-sweep, kept NMS indices exact
  and maps within ``tests/test_torch_frame.py``'s tolerances;
- ``Voxelization(voxelize_mode="hard")`` batches bit-equal to
  ``partner_tpu.data``.
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

from torch_port_fixtures import (CENTERPOINT, CENTERPOINT_VELO, FLAGSHIP,
                                 TINY_GRID, load_converted, randomize,
                                 synthetic_points, tiny_centerpoint_cfg,
                                 tiny_frame_cfg)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PR = np.array([0.3, -np.pi, -2.0, 75.18, np.pi, 4.0], np.float32)
VS = ((PR[3:] - PR[:3]) / np.array(TINY_GRID)).astype(np.float32)


def cloud(rng, n, pad, c=7, pr=PR):
    """(pad, c) cylinder points, the first n valid; some out of range."""
    pts = np.zeros((pad, c), np.float32)
    pts[:n, 0] = rng.uniform(pr[0] - 1, pr[3] + 1, n)
    pts[:n, 1] = rng.uniform(pr[1], pr[4], n)
    pts[:n, 2] = rng.uniform(pr[2] - 0.5, pr[5] + 0.5, n)
    pts[:n, 3:] = rng.rand(n, c - 3)
    mask = np.zeros(pad, bool)
    mask[:n] = True
    return pts, mask


@functools.lru_cache(maxsize=None)
def _jax_voxelize(grid, max_voxels):
    import jax

    from partner_tpu.ops import voxelize as jv

    return jax.jit(functools.partial(jv.dynamic_voxelize, grid_size=grid,
                                     max_voxels=max_voxels,
                                     return_point_voxel=True))


def jax_dynamic(pts, mask, vs, grid, max_voxels):
    out = _jax_voxelize(tuple(grid), max_voxels)(pts, mask, vs, PR)
    return {k: np.asarray(v) for k, v in out.items()}


def port_dynamic(pts, mask, vs, grid, max_voxels):
    from partner_tpu_torch.ops import voxelize as tv

    out = tv.dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                              vs, PR, grid, max_voxels,
                              return_point_voxel=True)
    return {k: v.numpy() for k, v in out.items()}


def _wrap_cloud(rng):
    """Points on both sides of the azimuth seam: phi = -pi (first column),
    just under +pi (last column) and +pi itself (one past the grid)."""
    pts, mask = cloud(rng, 600, 640)
    phis = np.array([-np.pi, np.nextafter(np.float32(np.pi), 0), np.pi],
                    np.float32)
    pts[:600, 1] = phis[rng.randint(0, 3, 600)]
    return pts, mask


# name -> (batch of (points, mask) made from a seed, voxel size, capacity)
def _cases():
    coarse = np.array([15.0, 2.0, 3.0], np.float32)
    out_of_range = cloud(np.random.RandomState(3), 300, 320)
    out_of_range[0][:, 0] = 200.0
    return {
        "below-capacity": ([cloud(np.random.RandomState(0), 2000, 2400),
                            cloud(np.random.RandomState(1), 1500, 2400)],
                           VS, 3000),
        "capacity-overflow": ([cloud(np.random.RandomState(2), 2000, 2400)],
                              VS, 500),
        "many-points-a-voxel": ([cloud(np.random.RandomState(4), 20000,
                                       20000)], coarse, 400),
        "all-out-of-range": ([out_of_range], VS, 256),
        "empty-cloud": ([(np.zeros((64, 7), np.float32),
                          np.zeros(64, bool))], VS, 128),
        "azimuth-wrap": ([_wrap_cloud(np.random.RandomState(5))], VS, 1000),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_dynamic_voxelize_matches_jax(case):
    clouds, vs, cap = CASES[case]
    grid = tuple(int(g) for g in np.round((PR[3:] - PR[:3]) / vs))
    pts = np.stack([c[0] for c in clouds])
    mask = np.stack([c[1] for c in clouds])
    got = port_dynamic(pts, mask, vs, grid, cap)      # the whole batch
    for i, (p, m) in enumerate(clouds):
        want = jax_dynamic(p, m, vs, grid, cap)
        assert sorted(got) == sorted(want)
        for k in ("coords", "mask", "num_points", "point_voxel"):
            assert got[k][i].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k][i], want[k], err_msg=k)
        np.testing.assert_allclose(got["features"][i], want["features"],
                                   rtol=1e-6, atol=0)
        n_vox = int(want["mask"].sum())
        if case == "capacity-overflow":
            assert n_vox == cap        # full: the lowest cell ids kept
            assert (want["point_voxel"] == cap).sum() > 1000
        elif case in ("all-out-of-range", "empty-cloud"):
            assert n_vox == 0 and not got["features"][i].any()
        elif case == "azimuth-wrap":
            cols = set(want["coords"][want["mask"]][:, 1].tolist())
            assert cols == {0, grid[1] - 1}
        elif case == "many-points-a-voxel":
            assert want["num_points"].max() > 100
        else:
            assert 0 < n_vox < cap


def test_dynamic_voxelize_of_no_rows():
    from partner_tpu_torch.ops import voxelize as tv

    out = tv.dynamic_voxelize(torch.zeros((2, 0, 5)),
                              torch.zeros((2, 0), dtype=torch.bool), VS, PR,
                              TINY_GRID, 16, return_point_voxel=True)
    assert out["features"].shape == (2, 16, 5) and not out["mask"].any()
    assert out["coords"].dtype == torch.int32
    assert out["point_voxel"].shape == (2, 0)


HARD_CASES = {"flagship": (5, 100000, VS), "small-capacity": (3, 64, VS),
              "one-point": (1, 4000, VS),
              "many-points-a-voxel": (8, 500, np.array([5.0, 0.5, 1.0],
                                                       np.float32))}


@pytest.mark.parametrize("case", list(HARD_CASES))
def test_points_to_voxel_and_generator_match_jax(case):
    from partner_tpu.ops import voxelize as jv
    from partner_tpu_torch.ops import voxelize as tv

    max_points, max_voxels, vs = HARD_CASES[case]
    pts, _ = cloud(np.random.RandomState(7), 5000, 5000, c=5)
    want = jv.points_to_voxel(pts, vs, PR, max_points, max_voxels)
    got = tv.points_to_voxel(pts, vs, PR, max_points, max_voxels)
    gen = tv.VoxelGenerator(vs, PR, max_points, max_voxels)
    jgen = jv.VoxelGenerator(vs, PR, max_points, max_voxels)
    np.testing.assert_array_equal(gen.grid_size, jgen.grid_size)
    for w, g, h in zip(want, got, gen.generate(pts)):
        assert g.dtype == w.dtype == h.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(h, w)
    assert len(want[0]) == min(max_voxels, len(want[0]))


def test_points_to_bev_matches_jax():
    from partner_tpu.ops import voxelize as jv
    from partner_tpu_torch.ops import voxelize as tv

    pts, _ = cloud(np.random.RandomState(8), 3000, 3000, c=4)
    vs = np.array([2.0, 0.1, 0.5], np.float32)
    for refl in (False, True):
        np.testing.assert_array_equal(
            tv.points_to_bev(pts, vs, PR, refl, max_voxels=800),
            jv.points_to_bev(pts, vs, PR, refl, max_voxels=800))


@pytest.mark.parametrize("reader", ["VoxelFeatureExtractorV3",
                                    "DynamicVoxelEncoderV1"])
def test_readers_match_jax(reader):
    import jax

    from partner_tpu.models import readers as jr  # noqa: F401
    from partner_tpu.models.registry import READERS as JREADERS
    from partner_tpu_torch.models.registry import READERS, build_from_cfg

    rng = np.random.RandomState(9)
    cfg = dict(type=reader, num_input_features=7)
    jm = JREADERS.get(reader)(num_input_features=7)
    tm = build_from_cfg(cfg, READERS)
    assert not list(tm.parameters())
    means = rng.randn(2, 50, 9).astype(np.float32)
    np.testing.assert_array_equal(
        tm(torch.from_numpy(means)).numpy(),
        np.asarray(jm.apply({}, means)))
    if reader == "VoxelFeatureExtractorV3":
        vox = rng.randn(2, 50, 5, 9).astype(np.float32)
        nump = rng.randint(0, 6, (2, 50)).astype(np.int32)
        want = np.asarray(jax.jit(jm.apply)({}, vox, nump))
        got = tm(torch.from_numpy(vox), torch.from_numpy(nump)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _voxel_inputs(pts, mask, model_cfg, max_voxels, kind, max_points=5):
    """The same example for both packages, numpy: dynamic means
    ("features") or hard voxels ("voxels") of one cloud."""
    from partner_tpu_torch.ops import voxelize as tv

    vg = model_cfg["bbox_head"]["voxel_generator"]
    vs = np.asarray(vg["voxel_size"], np.float32)
    pr = np.asarray(vg["range"], np.float32)
    grid = tuple(int(round((pr[3 + i] - pr[i]) / vs[i])) for i in range(3))
    if kind == "features":
        v = tv.dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                                vs, pr, grid, max_voxels)
        return {"features": v["features"].numpy(),
                "coords": v["coords"].numpy(),
                "voxel_mask": v["mask"].numpy()}
    voxels, coords, nump = tv.points_to_voxel(pts[0][mask[0]], vs, pr,
                                              max_points, max_voxels)
    n = len(voxels)
    ex = {"voxels": np.zeros((1, max_voxels) + voxels.shape[1:], np.float32),
          "num_points": np.zeros((1, max_voxels), np.int32),
          "coords": np.zeros((1, max_voxels, 3), np.int32),
          "voxel_mask": np.zeros((1, max_voxels), bool)}
    ex["voxels"][0, :n], ex["num_points"][0, :n] = voxels, nump
    ex["coords"][0, :n], ex["voxel_mask"][0, :n] = coords, True
    return ex


@pytest.mark.parametrize("trunk", ["trunk2d", "trunk3d"])
def test_polar_dense_fhd_voxel_path_matches_jax(trunk):
    import jax

    from partner_tpu.models import backbone_dense as jbd
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import backbone_dense as tbd

    rng = np.random.RandomState(10)
    m, _ = (tiny_frame_cfg() if trunk == "trunk2d"
            else tiny_centerpoint_cfg())
    bcfg = {k: v for k, v in m["backbone"].items() if k != "type"}
    pts, mask = synthetic_points(rng, m["bbox_head"]["voxel_generator"][
        "range"], 2000, 2400)
    ex = _voxel_inputs(pts, mask, m, 3000, "features")
    feats = ex["features"]
    jm = jbd.PolarDenseFHD(**{k: v for k, v in bcfg.items()
                              if k in jbd.PolarDenseFHD.__dataclass_fields__})
    args = (feats, ex["coords"], ex["voxel_mask"], TINY_GRID)
    v = jax.jit(functools.partial(jm.init, train=False),
                static_argnums=(4,))(jax.random.PRNGKey(0), *args)
    v = randomize(v, rng)
    want, _ = jax.jit(functools.partial(jm.apply, train=False),
                      static_argnums=(4,))(v, *args)
    tm = tbd.PolarDenseFHD(input_shape=TINY_GRID, **bcfg)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(ex["coords"]),
                 torch.from_numpy(ex["voxel_mask"]), TINY_GRID)
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


FRAME_CONFIGS = {"partner": FLAGSHIP, "centerpoint": CENTERPOINT,
                 "centerpoint-two-sweep": CENTERPOINT_VELO}


@functools.lru_cache(maxsize=None)
def _jax_model(config):
    """(model cfg, test cfg, JAX detector, randomized variables, points,
    mask) of one tiny config, built once for both input kinds."""
    import jax

    from partner_tpu.models import build_detector as jax_build

    rng = np.random.RandomState(11)
    m, tc = (tiny_frame_cfg() if config == "partner"
             else tiny_centerpoint_cfg(FRAME_CONFIGS[config]))
    c = m["backbone"]["num_input_features"]
    pts, mask = synthetic_points(rng, m["bbox_head"]["voxel_generator"][
        "range"], 2000, 2400, c=c)
    jdet = jax_build(m, None, tc)
    v = randomize(jdet.init(jax.random.PRNGKey(0), {
        "points": pts[:, :64], "points_mask": mask[:, :64]}), rng)
    return m, tc, jdet, v, pts, mask


@pytest.fixture(scope="module", params=[(c, k) for c in FRAME_CONFIGS
                                        for k in ("features", "voxels")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def voxel_frames(request):
    """Both packages' frame of one tiny config on the same voxel example:
    the JAX maps and detections, and the port's on each head route
    (PARTNER: per block, whole block)."""
    import jax

    from partner_tpu_torch.models import build_detector

    config, kind = request.param
    m, tc, jdet, v, pts, mask = _jax_model(config)
    ex = _voxel_inputs(pts, mask, m, 3000, kind)
    jmaps, jout = jax.jit(lambda v, e: (
        jdet.module.apply(v, e, train=False), jdet.predict(v, e)))(v, ex)
    routes = [False, True] if config == "partner" else [False]
    port = []
    for block in routes:
        tdet = build_detector(m, None, tc, device="cpu",
                              use_block_kernel=block)
        load_converted(tdet.module, v)
        tex = {k: torch.from_numpy(a) for k, a in ex.items()}
        with torch.no_grad():
            tmaps = tdet.module(tex)
        port.append((tmaps, tdet.predict(tex)))
    return config, jmaps, jout, port


def _flat_maps(maps):
    if "det_preds" in maps:
        return {f"task{i}/{k}": np.asarray(v)
                for i, t in enumerate(maps["det_preds"]) for k, v in t.items()}
    return {k: np.asarray(v) for k, v in maps.items()}


def test_voxel_frame_maps_match_jax(voxel_frames):
    _, jmaps, _, port = voxel_frames
    want = _flat_maps(jmaps)
    for tmaps, _ in port:
        got = _flat_maps({k: ([{n: x.numpy() for n, x in t.items()}
                               for t in v] if k == "det_preds" else
                              v.numpy()) for k, v in tmaps.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            # f32 on both sides, another summation order (test_torch_frame)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_voxel_frame_keeps_same_boxes(voxel_frames):
    config, _, jout, port = voxel_frames
    jout = {k: np.asarray(v) for k, v in jout.items()}
    for _, tout in port:
        tout = {k: v.numpy() for k, v in tout.items()}
        assert tout["mask"].shape == jout["mask"].shape
        assert tout["mask"].sum() > 10   # score_threshold 0: NMS at work
        np.testing.assert_array_equal(tout["mask"], jout["mask"])
        np.testing.assert_array_equal(tout["label_preds"],
                                      jout["label_preds"])
        m = jout["mask"]
        np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tout["box3d_lidar"][m],
                                   jout["box3d_lidar"][m], rtol=1e-4,
                                   atol=1e-4)


def test_hard_voxelization_batches_bit_equal(tmp_path):
    """``voxelize_mode="hard"`` in the flagship val pipeline: each batch's
    voxels, coords, counts and mask bit-equal to partner_tpu.data's."""
    import partner_tpu.data as jdata
    import partner_tpu.data.loader  # noqa: F401
    import partner_tpu_torch.data as tdata
    import partner_tpu_torch.data.loader  # noqa: F401
    from partner_tpu_torch.utils.config import load_config
    from test_data_pipeline import make_waymo_infos

    cfg = load_config(os.path.join(ROOT, FLAGSHIP))
    val = copy.deepcopy(cfg["data"]["val"])
    val.update(info_path=make_waymo_infos(tmp_path, n=4, seed=2),
               root_path=str(tmp_path))
    for stage in val["pipeline"]:
        if stage["type"] == "Voxelization":
            stage["cfg"] = dict(stage["cfg"], voxelize_mode="hard",
                                max_voxel_num=[4000, 6000])
    out = []
    for pkg in (jdata, tdata):
        ds = pkg.build_dataset(copy.deepcopy(val))
        out.append(list(pkg.loader.DataLoader(ds, 2, shuffle=False,
                                              num_workers=1,
                                              max_points=6000)))
    jb, tb = out
    assert len(tb) == len(jb) == 2
    for j, t in zip(jb, tb):
        assert sorted(t) == sorted(j) and t["metadata"] == j["metadata"]
        for k in ("voxels", "coords", "num_points", "voxel_mask", "points",
                  "points_mask"):
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert 0 < t["voxel_mask"].sum()
        assert t["voxels"].shape[1] <= 4000      # max_voxel_num[0]
