"""The PolarStream sector-streaming detector in partner_tpu_torch against
the JAX package (CPU, float32).

Both det configs (``configs/nusc/pp/polarstream_det_1_sector.py``: one
sector, ``RPNTECP``; ``polarstream_det_4_sector_bidirectional.py``: four
sectors, ``RPNBDCP``) cut to a 64 x 128 pillar grid, PFN filters [16, 16]
and a narrow three-scale stream neck (``torch_port_fixtures.
tiny_polarstream_cfg``), one JAX detector and one drawn, randomized flax
tree per sector count: the per-sector point buffers and rotations, the
head maps of every sector and the stateful-NMS detections of ``predict``
at batch 2 (one sweep crowded into one sector past its buffer's
capacity, points on the sector edges, masked rows holding points); a pair
of boxes planted across a sector edge, whose carried half suppresses its
twin; the sector targets of ``AssignLabel`` and their collated batch;
one 4-sector train step; both CLIs on both configs; the full widths on
the meta device; the raises of what is not ported.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_centerpoint import finish, port
from test_torch_nusc_train import ADAM_CLEAR, GRAD_RMS, OUT_RMS, four_ulp
from torch_port_fixtures import (POLAR_GRID,
                                 POLARSTREAM_CONFIGS, assert_same_detections,
                                 drawn_init, load_converted, nusc_batch,
                                 randomize, synthetic_points,
                                 tiny_polarstream_cfg, write_tiny_nusc_set,
                                 write_tiny_polarstream_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 both sides, another summation order: every sector's head maps
# measured within 4e-6 of maps up to ~3.5
MAP_TOL = 1e-5
N_POINTS, N_ROWS = 3000, 3600
SKEW = 1              # sample 1 crowds 2/3 of its points into sector 1
EDGE_Z = np.float32([0.5, 0.6, 0.7, 0.8])   # marks the sector-edge rows


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _recompute_xy(pts, rows):
    rho, phi = pts[rows, 0], pts[rows, 1]
    pts[rows, 3] = rho * np.cos(phi)
    pts[rows, 4] = rho * np.sin(phi)


def sweep(seed, pr, skew=None):
    """A (1, N_ROWS, 7) cylinder sweep (``synthetic_points``) with 4 rows
    on the edges of a 4-sector split (phi = float32 of range[1] + s x
    span, s = 1..3, and range[4]), 60 masked rows that copy valid ones,
    and with ``skew`` 2/3 of the points moved into that sector."""
    rng = np.random.RandomState(seed)
    pts, mask = synthetic_points(rng, pr, N_POINTS, N_ROWS)
    p = pts[0]
    span = (pr[4] - pr[1]) / 4
    if skew is not None:
        k = 2 * N_POINTS // 3
        p[:k, 1] = rng.uniform(pr[1] + skew * span,
                               pr[1] + (skew + 1) * span, k)
        _recompute_xy(p, slice(0, k))
    p[10:14, 1] = np.float32([pr[1] + s * span for s in (1, 2, 3)] + [pr[4]])
    p[10:14, 0] = 20.0
    p[10:14, 2] = EDGE_Z
    _recompute_xy(p, slice(10, 14))
    p[N_POINTS:N_POINTS + 60] = p[100:160]
    return pts, mask


@pytest.fixture(scope="module", params=[1, 4], ids=["1-sector", "4-sector"])
def pair(request):
    """One config in both packages from the same drawn, randomized tree, a
    batch of two sweeps (the second skewed), and the JAX head maps and
    ``predict`` of one jitted call."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    n_sec = request.param
    m, tc = tiny_polarstream_cfg(POLARSTREAM_CONFIGS[n_sec])
    pr = m["bbox_head"]["voxel_generator"]["range"]
    draws = [sweep(0, pr), sweep(1, pr, skew=SKEW)]
    ex = {"points": np.concatenate([d[0] for d in draws]),
          "points_mask": np.concatenate([d[1] for d in draws])}
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(1)
    v = randomize(drawn_init(jdet.module.init, rng, ex, train=False), rng)
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    jmaps, jout = jax.jit(lambda v, e: (jdet.module.apply(v, e, train=False),
                                        jdet.predict(v, e)))(v, ex)
    tex = {k: t(a) for k, a in ex.items()}
    with torch.no_grad():
        tmaps = tdet.module(tex)
    return dict(n=n_sec, m=m, tc=tc, pr=pr, jdet=jdet, v=v, tdet=tdet,
                ex=ex, tex=tex, jmaps=jmaps,
                jout={k: np.asarray(a) for k, a in jout.items()},
                tmaps=tmaps,
                tout={k: a.numpy() for k, a in tdet.predict(tex).items()})


def test_sector_inputs_match_jax(pair):
    """The points each sector's encoder takes: with 4 sectors the compact
    buffers of one stable sort (every column and the validity bit-equal,
    the crowded sector's rows past its capacity dropped as JAX drops them,
    masked rows in no sector), with 1 the azimuth-masked sweep; then
    re-referenced to sector 0: rho, phi - s x span, z, the extra columns
    and the validity bit-equal, x = rho cos and y = rho sin within two
    float32 ulps (XLA's and torch's float32 cos / sin differ by an ulp on
    a few percent of arguments; the product with rho reaches 2, measured)."""
    jm, tm = pair["jdet"].module, pair["tdet"].module
    pts, mask = pair["ex"]["points"], pair["ex"]["points_mask"]
    n_sec = pair["n"]
    assert tm.sector_point_cap(N_ROWS) == jm.sector_point_cap(N_ROWS)

    def jax_inputs(mod, p, m):
        if mod.n_sectors == 1:
            return [mod._rotate_to_sector(p, m, 0)], None
        bufs = mod._sector_buffers(p, m)
        return [mod._rotate_points(*bufs[s], s)
                for s in range(mod.n_sectors)], bufs

    want, wbufs = jm.apply(pair["v"], pts, mask, method=jax_inputs)
    got = tm.sector_inputs(pair["tex"]["points"], pair["tex"]["points_mask"])
    assert len(got) == len(want) == n_sec
    if n_sec > 1:
        cap = tm.sector_point_cap(N_ROWS)
        bufs = tm._sector_buffers(pair["tex"]["points"],
                                  pair["tex"]["points_mask"])
        for (gp, gv), (wp, wv) in zip(bufs, wbufs):
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        # sample 1 overflows its crowded sector's buffer
        assert int(bufs[SKEW][1][1].sum()) == cap < 2 * N_POINTS // 3
        # masked rows are in no sector; every valid row in one, or dropped
        kept = sum(int(v[0].sum()) for _, v in bufs)
        assert kept == int(mask[0].sum()) == N_POINTS
    n_ulp = 0
    for s, ((gp, gv), (wp, wv)) in enumerate(zip(got, want)):
        gp, wp = gp.numpy(), np.asarray(wp)
        exact = [0, 1, 2] + list(range(5, gp.shape[-1]))
        np.testing.assert_array_equal(gp[..., exact], wp[..., exact],
                                      err_msg=f"sector {s}")
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_max_ulp(gp[..., 3:5], wp[..., 3:5], 2)
        n_ulp += int((gp[..., 3:5] != wp[..., 3:5]).sum())
    assert n_ulp < 0.1 * 2 * N_ROWS * 2
    # the edge rows of sample 0: at 4 sectors range[1] + s x span goes to
    # sector s and turns to range[1] exactly (its first azimuth cell);
    # range[4] goes to the last sector by the clip and turns to that
    # sector's upper edge, outside its pillar grid. At 1 sector the first
    # three are selected, range[4] is not.
    pr = np.float32(pair["pr"])
    where = {}
    for s, (gp, gv) in enumerate(got):
        for j, z in enumerate(EDGE_Z):
            rows = (gp[0, :, 2] == float(z)) & gv[0]
            if rows.any():
                where[j] = (s, float(gp[0, rows, 1][0]))
    if n_sec == 1:
        assert sorted(where) == [0, 1, 2]
    else:
        span = np.float32(pr[4] - pr[1]) / 4
        assert where == {0: (1, pr[1]), 1: (2, pr[1]), 2: (3, pr[1]),
                         3: (3, float(np.float32(pr[4] - 3 * span)))}, where


def test_sector_maps_match_jax(pair):
    """Every sector's head maps (``CenterHeadSinglePos``: dim, height, hm,
    reg, rot, vel; (2, 32 / S, 16, .)) within ``MAP_TOL``: the pillar
    encoder on the sector grid at the rule's capacity, the neck's contexts
    passed on from sector to sector."""
    jsec = pair["jmaps"]["sector_preds"]
    tsec = pair["tmaps"]["sector_preds"]
    assert len(tsec) == len(jsec) == pair["n"]
    for s, (g, w) in enumerate(zip(tsec, jsec)):
        g, w = g["det_preds"][0], w["det_preds"][0]
        assert list(g) == sorted(w) == ["dim", "height", "hm", "reg", "rot",
                                        "vel"]
        assert g["hm"].shape == (2, 32 // pair["n"], 16, 10)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=MAP_TOL, atol=MAP_TOL,
                                       err_msg=f"sector {s} {k}")


def test_predict_matches_jax(pair):
    """``predict`` at batch 2 (83 kept a sector, 256 candidates into each
    sector's NMS, the carry of the previous sector prepended): the mask
    equal to JAX's; each sample's and sector's kept boxes, scores and
    labels equal at their place, within float32 rounding, or where two
    scores tie within 1e-6 at a place of that tie (one such pair, 3e-7
    apart, swaps at one sector for these draws)."""
    jout, tout = pair["jout"], pair["tout"]
    post = pair["tc"]["nms"]["nms_post_max_size"]
    assert tout["mask"].shape == jout["mask"].shape == (2, pair["n"] * post)
    assert tout["box3d_lidar"].shape[-1] == 7
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    assert tout["mask"].sum() > 0.9 * tout["mask"].size
    for b in range(2):
        for s in range(pair["n"]):
            rows = slice(s * post, (s + 1) * post)
            m = jout["mask"][b, rows]
            pick = lambda o: {k: o[k][b, rows][m] for k in
                              ("box3d_lidar", "scores", "label_preds")}
            assert_same_detections(pick(tout), pick(jout), box_tol=1e-4,
                                   score_tol=1e-6, tie=1e-6)
    np.testing.assert_array_equal(tout["label_preds"][~tout["mask"]], -1)
    np.testing.assert_array_equal(tout["scores"][~tout["mask"]], 0)


# ------------------------------------------------------ the stateful NMS

def planted_maps(det, rng):
    """4 sectors of head maps (B = 2) of near-zero scores (logit -6) with,
    in sample 0, one strong box of class 0 at the last azimuth row of
    sector 0 and a stronger twin of class 3 at the first row of sector 1,
    both placed by ``reg`` at the same point 0.03 rad before the shared
    edge, 25 m out. -> (numpy maps, the point (x, y))."""
    from partner_tpu_torch.models.center_head import _cell_corners

    mod = det.module
    span = mod.angle_span()
    h, w = 32 // 4, 16
    osf = mod.out_size_factor
    corners = _cell_corners((h, w), tuple(float(x) for x in det.voxel_size),
                            tuple(float(x) for x in mod.sector_range()),
                            osf, "cylinder", "cpu")[0][0].numpy()
    az = mod.pc_range[1] + span - 0.03
    target = 25.0 * np.array([np.cos(az), np.sin(az)])
    maps = []
    for s in range(4):
        m = {"hm": np.full((2, h, w, 10), -6.0),
             "reg": rng.uniform(-0.2, 0.2, (2, h, w, 2)),
             "height": rng.randn(2, h, w, 1),
             "dim": np.full((2, h, w, 3), np.log(0.3)),
             "rot": np.stack([np.zeros((2, h, w)), np.ones((2, h, w))], -1),
             "vel": rng.randn(2, h, w, 2)}
        m["hm"][1] += rng.randn(h, w, 10)
        if s < 2:
            row = h - 1 if s == 0 else 0
            ang = -s * span                      # into sector s's frame
            c, sn = np.cos(ang), np.sin(ang)
            local = np.array([c * target[0] - sn * target[1],
                              sn * target[0] + c * target[1]])
            m["reg"][0, row, 8] = local - corners[row * w + 8]
            m["hm"][0, row, 8, 3 * s] = 4.0 + s     # the twin: class 3
            m["dim"][0, row, 8] = np.log([4.5, 1.9, 1.6])
        maps.append({k: v.astype(np.float32) for k, v in m.items()})
    return maps, target


def test_carry_suppresses_the_twin_across_a_sector_edge():
    """The planted pair: sector 0 keeps its box, which lies within the
    0.2 rad margin of its leading edge and is carried; in sector 1 the
    carried box (its score + 1e4) suppresses the stronger twin of another
    class (the NMS is class-agnostic), so no sector-1 box lies near the
    point, while without the carry (a margin of 0) the twin is kept. The
    test config's ``per_class_nms``, ``stateful_nms``, ``max_per_img`` and
    ``interval`` are read by neither package: other values change no
    output. Every output equal to JAX's ``predict`` on the same maps, the
    planted sample and a noisy one."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.models.polarstream import \
        PolarStreamDetector as JDetector
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_polarstream_cfg(POLARSTREAM_CONFIGS[4])
    det = build_detector(m, None, tc, device="cpu")
    maps, target = planted_maps(det, np.random.RandomState(7))
    preds = {"sector_preds": [{"det_preds": [{k: t(v) for k, v in
                                              mp.items()}]} for mp in maps]}
    post = tc["nms"]["nms_post_max_size"]

    def near(out):
        """Per sector, the kept sample-0 boxes within 0.5 m of the
        point."""
        b, k = out["box3d_lidar"][0], out["mask"][0]
        d = np.hypot(b[:, 0] - target[0], b[:, 1] - target[1])
        return [int(((d < 0.5) & k)[s * post:(s + 1) * post].sum())
                for s in range(4)]

    got = {k: v.numpy() for k, v in det.decode(preds).items()}
    assert near(got) == [1, 0, 0, 0]
    unread = dict(per_class_nms=not tc["per_class_nms"], stateful_nms=False,
                  max_per_img=1, interval=0.0)
    other = copy.copy(det)
    other.test_cfg = dict(tc, **unread)
    for k, v in other.decode(preds).items():
        assert np.array_equal(v.numpy(), got[k]), k
    det.carry_margin = 0.0
    assert near({k: v.numpy() for k, v in det.decode(preds).items()}) == [
        1, 1, 0, 0]

    jmod = jax_build(m, None, tc).module

    class Planted:
        """The JAX module with ``apply`` giving the planted maps."""

        def apply(self, *args, **kwargs):
            return {"sector_preds": [{"det_preds": [{
                k: jnp.asarray(v) for k, v in mp.items()}]} for mp in maps]}

        def __getattr__(self, name):
            return getattr(jmod, name)

    jdet = JDetector(Planted(), code_weights=[1.0] * 10, weight=0.5,
                     voxel_size=det.voxel_size, test_cfg=tc)
    want = {k: np.asarray(v) for k, v in jdet.predict(None, None).items()}
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["label_preds"], want["label_preds"])
    k = want["mask"]
    np.testing.assert_allclose(got["box3d_lidar"][k], want["box3d_lidar"][k],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["scores"][k], want["scores"][k],
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- sector targets

def _assign_label(pkg, nsectors):
    import importlib

    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, POLARSTREAM_CONFIGS[4]))
    mod = importlib.import_module(f"{pkg}.data.pipeline")
    return mod.AssignLabel(dict(cfg["train_cfg"]["assigner"],
                                nsectors=nsectors), rectify=True)


def sector_boxes(rng, pr, n=14):
    """(n, 9) nuScenes boxes [x, y, z, dx, dy, dz, vx, vy, yaw] over the
    polar range, the first on the edge between sectors 1 and 2 of 4 and
    the second on the edge of 2, all of class 1-10 -> (boxes, classes)."""
    span = (pr[4] - pr[1]) / 4
    rho = rng.uniform(5, 45, n)
    phi = rng.uniform(pr[1], pr[4], n)
    phi[:2] = [pr[1] + 2 * span, pr[1] + span]
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0], boxes[:, 1] = rho * np.cos(phi), rho * np.sin(phi)
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    boxes[:, 6:8] = rng.randn(n, 2)
    boxes[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return boxes, rng.randint(1, 11, n)


@pytest.mark.parametrize("nsectors", [2, 4])
def test_assign_label_sectors_match_jax(nsectors):
    """``AssignLabel`` with cylinder sectors on the tiny grid: every
    target (``hm``, ``anno_box``, ``ind``, ``mask``, ``cat``, each (S, ...)
    per task; ``votemap`` and ``global_box`` whole-sweep) bit-equal to
    JAX's for two sweeps of 14 boxes, two on sector edges; every box lands
    in one sector; then the port's collated batch: each target (B, S,
    ...), ``hm`` NHWC per sector, equal to JAX's per-sample targets
    stacked (JAX's own collate cannot stack them: its (B, C, az, r)
    transpose raises on the sector axis, ROADMAP.md §3)."""
    from partner_tpu_torch.data.collate import collate

    m, _ = tiny_polarstream_cfg()
    vg = m["bbox_head"]["voxel_generator"]
    pr = np.asarray(vg["range"], np.float32)
    meta = dict(shape=np.asarray([POLAR_GRID[0], POLAR_GRID[1], 1]),
                range=pr, size=np.asarray(vg["voxel_size"], np.float32))
    rng = np.random.RandomState(12)
    samples, jaxs = [], []
    for _ in range(2):
        boxes, classes = sector_boxes(rng, pr)
        outs = []
        for pkg in ("partner_tpu_torch", "partner_tpu"):
            res = {"mode": "train", "lidar": {
                "voxels": dict(meta), "annotations": {
                    "gt_boxes": boxes.copy(), "gt_classes": classes.copy()}}}
            outs.append(_assign_label(pkg, nsectors)(res, {})[0]["lidar"][
                "targets"])
        got, want = outs
        assert sorted(got) == sorted(want)
        for k in want:
            for g, w in (zip(got[k], want[k]) if isinstance(want[k], list)
                         else [(got[k], want[k])]):
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)
        assert got["hm"][0].shape == (nsectors, 10, POLAR_GRID[1] // 4
                                      // nsectors, POLAR_GRID[0] // 4)
        assert int(got["mask"][0].sum()) == len(boxes)
        samples.append(dict(got, points=np.zeros((5, 7), np.float32)))
        jaxs.append(want)
    batch = collate(samples, max_points=8)
    from partner_tpu.data.collate import collate as jax_collate

    with pytest.raises(ValueError, match="axes don't match"):
        jax_collate(samples, max_points=8)
    for k in ("hm", "anno_box", "ind", "mask", "cat"):
        want = np.stack([j[k][0] for j in jaxs])
        if k == "hm":
            want = want.transpose(0, 1, 3, 4, 2)
        assert batch[k][0].shape[:2] == (2, nsectors)
        np.testing.assert_array_equal(batch[k][0], want, err_msg=k)


def test_pillar_capacity_keeps_the_lowest_azimuth_rows(pair):
    """Each sector's pillar capacity keeps the lowest linear cell ids
    ``az x n_r + r`` (``dynamic_voxelize``), so at a capacity of 96 a
    sector the kept pillars are the sector's lowest azimuth rows and every
    dropped occupied cell lies above them; the slots, coords and each
    row's pillar bit-equal to JAX's ``_encode_sector`` pillarizer on the
    same rotated points."""
    from partner_tpu.ops.voxelize import dynamic_voxelize as jax_voxelize
    from partner_tpu_torch.ops.voxelize import dynamic_voxelize

    mod = pair["tdet"].module
    sr, g = mod.sector_range(), mod.sector_grid()
    vs = np.float32([mod.voxel_size[0], mod.voxel_size[1], sr[5] - sr[2]])
    cap = 96
    for s, (p, v) in enumerate(mod.sector_inputs(
            pair["tex"]["points"], pair["tex"]["points_mask"])):
        got = dynamic_voxelize(p, v, vs, np.float32(sr), (g[0], g[1], 1),
                               cap, return_point_voxel=True, features=False)
        want = jax.vmap(lambda q, m: jax_voxelize(
            q, m, jnp.asarray(vs), jnp.asarray(sr, jnp.float32),
            (g[0], g[1], 1), max_voxels=cap, return_point_voxel=True))(
            p.numpy(), v.numpy())
        for k in ("coords", "mask", "point_voxel"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        co = np.floor((p.numpy()[0, :, :3] - np.float32(sr[:3])) / vs)
        ok = v.numpy()[0] & (co >= 0).all(1) & (co < [g[0], g[1], 1]).all(1)
        lin = np.unique(co[ok, 1] * g[0] + co[ok, 0]).astype(np.int64)
        kept = got["coords"][0].numpy()[got["mask"][0].numpy()]
        kept_lin = np.sort(kept[:, 1].astype(np.int64) * g[0] + kept[:, 2])
        assert len(lin) > cap and len(kept_lin) == cap, s
        np.testing.assert_array_equal(kept_lin, lin[:cap])


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def nusc_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("polarstream"))
    return root, write_tiny_nusc_set(root, seed=14)


def test_train_step_matches_jax(nusc_set):
    """One 4-sector step at batch 2 on a train batch of the config's
    pipeline (sector targets through ``AssignLabel`` and ``collate``),
    from one drawn, randomized tree, against ``jax.jit(make_train_step)``,
    by the rules of ``tests/test_torch_nusc_train.py``: the per-sector and
    total losses at rtol 1e-5, the gradient norm within 1e-5 or 3x the
    reference's own spread under a rounding-sized weight move; each
    gradient within ``GRAD_RMS`` relative RMS (the heads' output convs
    within ``OUT_RMS``) or 3x the reference's own spread under that move
    (the train-mode network upstream of the head is chaotic at random
    weights: one neck norm scale's gradient lies 1.034e-2 from JAX's, and
    JAX's own moves 1.034e-2 under the weight move), a
    ``ConvGNStack``'s hidden conv bias, whose
    gradient its GroupNorm takes out, under 1e-5 of the largest gradient;
    the BatchNorm statistics after the 4 chained sector updates at 1e-5;
    the parameters within 2 lr of the start and at 2e-6 where Adam's
    first step is determined."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    root, info = nusc_set
    m, tc = tiny_polarstream_cfg(POLARSTREAM_CONFIGS[4])
    det = build_detector(m, None, tc, device="cpu")
    batch = nusc_batch(POLARSTREAM_CONFIGS[4], m, info, root, "train", 2,
                       seed=6)
    ex = {k: batch[k] for k in det.loss_keys}
    assert ex["hm"][0].shape == (2, 4, 8, 16, 10)
    assert int(ex["mask"][0].sum()) > 10
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(3)
    v = randomize(drawn_init(jdet.module.init, rng, {
        k: ex[k] for k in ("points", "points_mask")}, train=False), rng)
    lr_max, total = 3e-3, 1000
    tx = jax_opt(lr_max=lr_max, total_steps=total)
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    jstep = jax.jit(lambda s: jax_step(jdet, tx)(s, jex,
                                                  jax.random.PRNGKey(1)))
    new_state, jmet = jstep(create_train_state(v, tx))
    moved_state, moved_met = jstep(create_train_state(
        four_ulp(v, np.random.RandomState(9)), tx))

    load_converted(det.module, v)
    opt = build_one_cycle_optimizer(det.module, lr_max, total)
    met = make_train_step(det, opt)(
        {k: [t(a) for a in x] if isinstance(x, list) else t(x)
         for k, x in ex.items()}, torch.Generator().manual_seed(0))

    assert sorted(met) == sorted(jmet) == sorted(
        ["grad_norm", "loss"] + [f"sector{s}_loss" for s in range(4)])
    for k in sorted(met):
        if k != "grad_norm":
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5, err_msg=k)
    norm, jnorm = float(met["grad_norm"]), float(jmet["grad_norm"])
    spread = abs(float(moved_met["grad_norm"]) - jnorm) / jnorm
    assert abs(norm - jnorm) / jnorm <= max(1e-5, 3 * spread), (
        norm, jnorm, spread)

    b1 = np.float32(0.95)

    def grads(state):
        return flax_to_torch({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) / (np.float32(1) - b1),
            state.opt_state.inner_state[1].mu)})

    want, moved = grads(new_state), grads(moved_state)
    scale = min(1.0, 35.0 / norm)
    params = dict(det.module.named_parameters())
    assert sorted(want) == sorted(params)
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for name, p in params.items():
        g, r = p.grad.numpy() * scale, want[name].numpy()
        if "_stack.Conv_0.bias" in name:
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-5 * gmax, name
            continue
        out = "reg_out." in name or "_stack.Conv_1." in name
        bound = max(OUT_RMS if out else GRAD_RMS,
                    3 * rel(moved[name].numpy(), r))
        assert rel(g, r) <= bound, (name, rel(g, r), bound)

    lr0 = lr_max / 10.0
    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    sd = det.module.state_dict()
    assert sorted(after) == sorted(sd)
    n_firm = n_all = 0
    for k, r in after.items():
        got, r = sd[k].numpy(), r.numpy()
        if k not in params:
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        assert np.all(np.abs(got - r) <= 2 * lr0 * 1.01 + 1e-6), k
        g, gr = params[k].grad.numpy() * scale, want[k].numpy()
        firm = (np.abs(gr) > ADAM_CLEAR) & (np.abs(g - gr)
                                            <= 1e-2 * np.abs(gr))
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        n_firm += int(firm.sum())
        n_all += firm.size
    assert n_firm >= 0.5 * n_all, (n_firm, n_all)


# ------------------------------------------------------------ entry points

_PORT_CLIS = r"""
import json, os, pickle, sys
import numpy as np, torch
from partner_tpu_torch.data import build_dataset
from partner_tpu_torch.data.loader import DataLoader
from partner_tpu_torch.eval import evaluator
from partner_tpu_torch.models import build_detector
from partner_tpu_torch.tools import dist_test, train
from partner_tpu_torch.train.checkpoint import load_checkpoint
from partner_tpu_torch.utils.config import load_config
work = sys.argv[1]
orig = evaluator.build_dataloader
# one loader thread: each frame draws its sweep order in frame order
evaluator.build_dataloader = lambda ds, bs, **kw: orig(
    ds, bs, **dict(kw, workers_per_gpu=1))
out = {}
for cfg in sys.argv[2:]:
    name = os.path.splitext(os.path.basename(cfg))[0]
    common = ["--device", "cpu", "--max_points", "5000"]
    steps = train.main([cfg, "--work_dir", os.path.join(work, name, "train"),
                        "--batch_size", "2", "--total_steps", "2",
                        "--max_steps_per_epoch", "2"] + common)
    ckpt = os.path.join(work, name, "train", "latest")
    results, fps = dist_test.main([
        cfg, "--checkpoint", ckpt,
        "--work_dir", os.path.join(work, name, "eval")] + common)
    c = load_config(cfg)
    det = build_detector(c["model"], None, c["test_cfg"], device="cpu")
    det.module.load_state_dict(load_checkpoint(ckpt)[0]["state_dict"])
    with open(os.path.join(work, name, "eval", "prediction.pkl"), "rb") as f:
        preds = pickle.load(f)
    equal = []
    for b in DataLoader(build_dataset(dict(c["data"]["val"])), 1,
                        shuffle=False, num_workers=1, max_points=5000):
        o = det.predict({k: torch.from_numpy(b[k])
                         for k in ("points", "points_mask")})
        keep = o["mask"][0]
        p = preds[b["metadata"][0]["token"]]
        equal.append(all(np.array_equal(p[k], o[k][0][keep].numpy())
                         for k in ("box3d_lidar", "scores", "label_preds")))
    out[name] = {"steps": steps, "metrics": results[0], "equal": equal}
out["bad"] = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                     "partner_tpu")]
print(json.dumps(out))
"""


def test_clis_on_the_cpu(nusc_set, tmp_path):
    """Both configs through ``train`` (two steps at batch 2, the 4-sector
    config's targets (B, S, ...)) then ``dist_test`` from its checkpoint,
    ``--device cpu``, in one fresh process that imports nothing of JAX:
    finite per-sector losses and nuScenes metrics, velocities 0 in the
    results (``predict`` keeps 7 columns), and every frame's kept boxes
    bit-equal to a direct ``predict`` of the frame from the checkpoint in
    that process. ``dist_test``'s loader runs one thread there: with its
    4, each frame draws its sweep order from the dataset's random state in
    the order the threads reach it, and the PFN sums a pillar's points in
    their order (ROADMAP.md §3)."""
    root, info = nusc_set
    cfgs = {n: write_tiny_polarstream_config(
        str(tmp_path / f"polar{n}.py"), info, info, root, config)
        for n, config in POLARSTREAM_CONFIGS.items()}
    res = finish(port(["-c", _PORT_CLIS, str(tmp_path)] + list(
        cfgs.values())))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got.pop("bad") == []
    for n in cfgs:
        name = f"polar{n}"
        assert got[name]["steps"] == 2
        assert got[name]["equal"] == [True] * 4
        assert all(np.isfinite(got[name]["metrics"][k]) for k in ("mAP",
                                                                  "NDS"))
        with open(tmp_path / name / "train" / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs] == [0, 1]
        for r in recs:
            assert sorted(k for k in r if k.startswith("sector")) == [
                f"sector{s}_loss" for s in range(n)]
            assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        with open(got[name]["metrics"]["results_path"]) as f:
            results = json.load(f)["results"]
        assert sum(map(len, results.values())) > 0
        assert all(d["velocity"] == [0.0, 0.0] for ds in results.values()
                   for d in ds)


# ------------------------------------------------------------- full width

@pytest.mark.parametrize("n_sec", [1, 4])
def test_full_width_builds_with_jax_parameter_count(n_sec):
    """Each config at full width on the meta device: the 512 x 512 pillar
    grid cut into (512, 512 / S) sector grids, the capacity rule's 30,000
    / 7,504 pillars a sector, the PFN 5 -> [64, 128] (14 decorated
    inputs), the neck ``RPNTECP`` / ``RPNBDCP`` told ``nsectors``, and
    every leaf's name and shape equal to ``jax.eval_shape`` of the JAX
    detector's init."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, POLARSTREAM_CONFIGS[n_sec]))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    mod = det.module
    assert mod.grid_size[:2] == (512, 512) and mod.n_sectors == n_sec
    assert mod.sector_grid()[:2] == (512, 512 // n_sec)
    assert mod.max_pillars == {1: 30000, 4: 7504}[n_sec]
    assert type(mod.neck).__name__ == {1: "RPNTECP", 4: "RPNBDCP"}[n_sec]
    assert mod.neck.nsectors == n_sec
    assert tuple(mod.reader.pfn0_dense.weight.shape) == (64, 14)
    ex = {"points": np.zeros((1, 64, 7), np.float32),
          "points_mask": np.zeros((1, 64), bool)}
    shapes = jax.eval_shape(lambda: jax_build(
        cfg["model"], cfg["train_cfg"], cfg["test_cfg"]).module.init(
        jax.random.PRNGKey(0), ex, train=False))
    want = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
    sd = mod.state_dict()
    assert sorted(want) == sorted(sd)
    for k, x in sd.items():
        assert tuple(want[k].shape) == tuple(x.shape), k


def test_what_is_not_ported_raises():
    """The seg configs, once a raise naming queue 1 item 5, build with
    their seg head (held against JAX in ``tests/test_torch_seg.py``);
    cuboid sectors and the ``RPNUber`` / ``RPNWaymo`` necks, once raises
    naming item 7, build too (held against JAX in
    ``tests/test_torch_strobe.py`` and ``test_torch_rpn_stream.py``); a
    neck that takes no sector context (``RPN``, ``RPNHalo``) raises, as
    JAX's sector loop would at its first call; so does the E2E head's
    block route."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    for c in ("1_sector", "4_sector_bidirectional", "4_sector_trailing_edge"):
        cfg = load_config(os.path.join(
            ROOT, f"configs/nusc/pp/polarstream_det_n_seg_{c}.py"))
        det = build_detector(cfg["model"], cfg["train_cfg"],
                             cfg["test_cfg"], device="meta")
        assert type(det.module.seg_head).__name__ == "SingleConvHead"
        assert "points_label" in det.loss_keys
    m, tc = tiny_polarstream_cfg()
    cuboid = copy.deepcopy(m)
    cuboid["bbox_head"]["voxel_shape"] = "cuboid"
    det = build_detector(cuboid, None, tc, device="meta")
    assert det.module.voxel_shape == "cuboid"
    assert det.module.azimuth_origin() == -np.pi
    for neck in ("RPNUber", "RPNWaymo"):
        det = build_detector(dict(m, neck=dict(m["neck"], type=neck)), None,
                             tc, device="meta")
        assert type(det.module.neck).__name__ in (neck, "RPNWaymoLSTM")
    for neck in ("RPN", "RPNHalo"):
        with pytest.raises(ValueError, match="takes none"):
            build_detector(dict(m, neck=dict(m["neck"], type=neck)), None,
                           tc, device="meta")
    with pytest.raises(ValueError, match="use_block_kernel"):
        build_detector(m, None, tc, device="meta", use_block_kernel=True)
