"""HAN and STROBE in partner_tpu_torch against the JAX package (CPU,
float32).

The four configs ``configs/nusc/pp/{han_1_sector,han_4_sectors,
strobe_1_sector,strobe_4_sector}.py`` (and ``PointPillarsNoLSTM``,
``STROBEV2``, ``STROBEV3`` on their configs) cut to a 64 x 64 pillar grid
(the voxel size x 8), PFN [16, 16], a narrow three-scale neck and 2,048
pillars (``torch_port_fixtures.tiny_strobe_cfg``), one JAX detector and
one drawn, randomized flax tree per model, a batch of two samples (HAN:
(2, 3600, 7) points, the second crowding 2/3 of its points into one
wedge; STROBE: (2, 2, 1800, 7), two sweeps a sample, the warped variants
with ``sweep_transforms``): every head and seg map, ``predict``'s kept
boxes and point labels; the cuboid sector buffers and their turn; the
sector LSTM's memory; the cuboid sector targets; the full widths on the
meta device.

The points lie at least 1 mm off every pillar edge of the 1.6 m cells
(the axes among them: ``torch_port_fixtures.cuboid_points``): a cuboid
sector turns its points by float32 ``cos`` / ``sin`` of their
``arctan2``, which XLA and torch round apart by an ulp, so a point within
an ulp of an edge could change pillar or sector between the packages.
``test_cuboid_sector_inputs_match_jax`` counts such points on a draw left
as it is.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (STROBE_GRID, STROBE_HAN_CONFIGS,
                                 assert_same_detections, cuboid_points,
                                 drawn_init, load_converted, randomize,
                                 tiny_strobe_cfg)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 both sides, another summation order: every map measured within
# 2.7e-5 of maps up to ~57 (the seg logits), 1e-5 of the head maps
MAP_TOL = 1e-5
CELL = 102.4 / STROBE_GRID    # the tiny grid's pillar side, 1.6 m
N_POINTS, N_ROWS = 3000, 3600
SWEEP_POINTS, SWEEP_ROWS = 1500, 1800
MODELS = {"han-1": ("han-1", None), "han-4": ("han-4", None),
          "han-4-nolstm": ("han-4", "PointPillarsNoLSTM"),
          "strobe-1": ("strobe-1", None), "strobe-4": ("strobe-4", None),
          "strobe-v2": ("strobe-1", "STROBEV2"),
          "strobe-v3": ("strobe-1", "STROBEV3")}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def example(name, pr, seed=0, margin=1e-3):
    """The batch of ``name``: HAN (2, N_ROWS, 7), sample 1 with 2/3 of its
    points in the wedge [-pi/2, 0) (sector 1 of 4); STROBE (2, 2,
    SWEEP_ROWS, 7), the warped variants with ``sweep_transforms`` (the
    first sweep's identity, then a move of ~2 m and ~0.15 rad)."""
    from partner_tpu.ops.warp import make_bev_transform

    rng = np.random.RandomState(seed)
    if name.startswith("han"):
        draws = [cuboid_points(rng, pr, N_POINTS, N_ROWS, CELL, margin),
                 cuboid_points(rng, pr, N_POINTS, N_ROWS, CELL, margin,
                               wedge=(-np.pi / 2, 0.0))]
        return {"points": np.concatenate([d[0] for d in draws]),
                "points_mask": np.concatenate([d[1] for d in draws])}
    draws = [[cuboid_points(rng, pr, SWEEP_POINTS, SWEEP_ROWS, CELL, margin)
              for _ in range(2)] for _ in range(2)]
    ex = {"points": np.stack([np.concatenate([d[0] for d in s])
                              for s in draws]),
          "points_mask": np.stack([np.concatenate([d[1] for d in s])
                                   for s in draws])}
    if name in ("strobe-v2", "strobe-v3"):
        tf = np.asarray(make_bev_transform(
            jnp.float32([1.0, -2.0]), jnp.float32([0.5, 1.5]),
            jnp.float32([0.1, -0.2])))
        ex["sweep_transforms"] = np.stack(
            [np.stack([np.eye(3, dtype=np.float32), tf[b]]) for b in
             range(2)])
    return ex


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """One model in both packages from one drawn, randomized tree, its
    batch, and the JAX maps and ``predict`` of one jitted call (the call
    kept for other inputs of the same shapes)."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    name = request.param
    config, variant = MODELS[name]
    m, tc = tiny_strobe_cfg(STROBE_HAN_CONFIGS[config], variant)
    pr = m["bbox_head"]["voxel_generator"]["range"]
    ex = example(name, pr)
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(1)
    v = randomize(drawn_init(jdet.module.init, rng, ex, train=False), rng)
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    run = jax.jit(lambda v, e: (jdet.module.apply(v, e, train=False),
                                jdet.predict(v, e)))
    jmaps, jout = run(v, ex)
    tex = {k: t(a) for k, a in ex.items()}
    with torch.no_grad():
        tmaps = tdet.module(tex)
    return dict(name=name, m=m, tc=tc, pr=pr, jdet=jdet, v=v, run=run,
                tdet=tdet, ex=ex, tex=tex, jmaps=jmaps, tmaps=tmaps,
                jout={k: np.asarray(a) for k, a in jout.items()},
                tout={k: a.numpy() for k, a in tdet.predict(tex).items()})


def flat_maps(maps):
    """[(name, map)] of a module's output: each sector's (or the one
    head's) det maps, then each seg map."""
    secs = maps.get("sector_preds") or [maps]
    out = [(f"sector {s} {k}", p["det_preds"][0][k]) for s, p in
           enumerate(secs) for k in sorted(p["det_preds"][0])]
    segs = maps["seg_preds"]
    segs = segs if isinstance(segs, (list, tuple)) else [segs]
    return out + [(f"seg {s}", v) for s, v in enumerate(segs)]


def test_maps_match_jax(pair):
    """Every head map (``CenterHeadSingle``: dim, height, hm, reg, rot,
    vel; (2, 16, 16, .) on the whole grid, (2, 8, 8, .) a sector) and every
    seg map ((2, 64, 64, 16) or (2, 32, 32, 16) a sector) within
    ``MAP_TOL``, relative and absolute: the pillar encoder at the capacity
    rule, the neck's contexts passed on from sweep to sweep or sector to
    sector, the sector LSTM, the warps."""
    got, want = flat_maps(pair["tmaps"]), flat_maps(pair["jmaps"])
    n_sec = 4 if pair["name"] in ("han-4", "han-4-nolstm",
                                  "strobe-4") else 1
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len(want) == 7 * n_sec
    side = 32 if n_sec == 4 else 64     # a sector's pillar grid side
    for k, w in want:
        g = dict(got)[k]
        assert tuple(g.shape[1:3]) == ((side // 4,) * 2 if
                                       k.startswith("sector")
                                       else (side, side)), k
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MAP_TOL,
                                   atol=MAP_TOL, err_msg=k)


def test_predict_matches_jax(pair):
    """``predict`` at batch 2 (83 kept a sector or task, 256 candidates
    into each NMS, the previous sector's carry prepended at 4 sectors):
    the mask equal to JAX's; each sample's kept boxes, scores and labels
    equal at their place within float32 rounding, or where two scores tie
    within 1e-6 at a place of that tie; ``point_seg_labels`` (of the last
    sweep's points for STROBE) equal."""
    jout, tout = pair["jout"], pair["tout"]
    assert sorted(tout) == sorted(jout)
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    assert tout["mask"].sum() > 0.5 * tout["mask"].size
    for b in range(2):
        m = jout["mask"][b]
        pick = lambda o: {k: o[k][b][m] for k in ("box3d_lidar", "scores",
                                                 "label_preds")}
        assert_same_detections(pick(tout), pick(jout), box_tol=1e-4,
                               score_tol=1e-6, tie=1e-6)
    np.testing.assert_array_equal(tout["point_seg_labels"],
                                  jout["point_seg_labels"])
    rows = SWEEP_ROWS if pair["name"].startswith("strobe") else N_ROWS
    assert tout["point_seg_labels"].shape == (2, rows)
    assert (tout["point_seg_labels"] > 0).mean() > 0.5


@pytest.mark.parametrize("pair", ["han-4"], indirect=True)
def test_cuboid_sector_inputs_match_jax(pair):
    """The 4 cuboid sectors of the batch: the compact buffers of one
    stable sort by ``arctan2`` wedge from -pi bit-equal to JAX's (the
    crowded wedge of sample 1 past its buffer's 1,536 rows, dropped as
    JAX drops them); each sector turned by -s x pi / 2 (``hypot``,
    ``arctan2 - s x span``, ``cos`` / ``sin``): z and the extra columns
    bit-equal, x and y within 4 float32 ulps of JAX's, every turned point
    in [-pi, -pi / 2) and in the reduced box x, y <= 0, and in the same
    pillar as JAX puts it. On the same draw without the 1 mm margin, the
    points that change pillar or sector between the packages are counted:
    0 of 7,200 for this draw (each would need an x or y within an ulp of
    an edge)."""
    jm, tm = pair["jdet"].module, pair["tdet"].module

    def jax_inputs(mod, p, m):
        bufs = mod._sector_buffers(p, m)
        return [mod._rotate_points(*bufs[s], s)
                for s in range(mod.n_sectors)], bufs

    def cells(p):
        return np.floor((p[..., :2] + 51.2) / np.float32(CELL))

    for margin in (1e-3, 0.0):
        ex = example("han-4", pair["pr"], margin=margin)
        want, wbufs = jm.apply(pair["v"], ex["points"], ex["points_mask"],
                               method=jax_inputs)
        pts, mask = t(ex["points"]), t(ex["points_mask"])
        bufs = tm._sector_buffers(pts, mask)
        got = tm.sector_inputs(pts, mask)
        moved = 0
        for s, ((gb, gbv), (wb, wbv), (gp, gv), (wp, wv)) in enumerate(
                zip(bufs, wbufs, got, want)):
            np.testing.assert_array_equal(gbv.numpy(), np.asarray(wbv))
            gp, wp, gv = gp.numpy(), np.asarray(wp), gv.numpy()
            if margin:
                np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
                np.testing.assert_array_equal(gp[..., 2:], wp[..., 2:])
                np.testing.assert_array_max_ulp(gp[..., :2], wp[..., :2], 4)
                phi = np.arctan2(gp[gv][:, 1], gp[gv][:, 0])
                assert (phi >= -np.pi).all() and (phi < -np.pi / 2 + 1e-6
                                                  ).all(), s
                assert (gp[gv][:, :2] <= 1e-5).all(), s
            moved += int(((cells(gp) != cells(wp)).any(-1) & gv).sum())
        if margin:
            assert moved == 0
            cap = tm.sector_point_cap(N_ROWS)
            assert cap == 1536 and int(bufs[1][1][1].sum()) == cap
        else:
            assert moved == 0, moved


@pytest.mark.parametrize("pair", ["han-4"], indirect=True)
def test_sector_lstm_memory_is_live(pair):
    """Sample 0 with sector 0's points masked out: sector 0's maps change,
    and so does sector 1's heatmap, whose canvas takes the LSTM's output
    of sector 0's canvas mean (and whose neck takes the ConvLSTM state),
    in both packages alike (within ``MAP_TOL``)."""
    ex = dict(pair["ex"])
    phi = np.arctan2(ex["points"][..., 1], ex["points"][..., 0])
    ex["points_mask"] = ex["points_mask"] & ~((phi < -np.pi / 2)
                                              & (np.arange(2) == 0)[:, None])
    jmaps, _ = pair["run"](pair["v"], ex)
    with torch.no_grad():
        tmaps = pair["tdet"].module({k: t(a) for k, a in ex.items()})
    for s in (0, 1):
        w = np.asarray(jmaps["sector_preds"][s]["det_preds"][0]["hm"])
        g = tmaps["sector_preds"][s]["det_preds"][0]["hm"].numpy()
        before = np.asarray(pair["jmaps"]["sector_preds"][s]["det_preds"][0]
                            ["hm"])
        np.testing.assert_allclose(g, w, rtol=MAP_TOL, atol=MAP_TOL)
        assert np.abs(w[0] - before[0]).max() > 1e-2, s
        np.testing.assert_allclose(w[1], before[1], rtol=MAP_TOL,
                                   atol=MAP_TOL)


# ------------------------------------------------------- sector targets

@pytest.mark.parametrize("nsectors", [2, 4])
def test_assign_label_cuboid_sectors_match_jax(nsectors):
    """``AssignLabel`` with cuboid sectors (HAN 4-sector's assigner at 2
    and 4 sectors) on the tiny grid: boxes by center ``arctan2`` into
    wedges from -pi, each turned by -s x span, assigned on
    ``cart_sector_spec``'s reduced grid (64 x 32 at 2 sectors, 32 x 32 at
    4) and range: every target bit-equal to JAX's for two samples of 14
    boxes, two on wedge edges (azimuth -pi / 2 and 0); every box in one
    sector but those the turn puts on the reduced box's edge y = 0, whose
    center rounds onto row 8 of the 8-row map, so both packages drop them:
    the box at azimuth 0 (turned by -pi at 2 sectors, -pi at 4), and at 4
    sectors the one at -pi / 2 too (turned by -pi / 2 to a y a few 1e-15
    m below 0); the port's collated batch (B, S, ...), ``hm`` NHWC per
    sector, equal to JAX's per-sample targets stacked."""
    import importlib

    from partner_tpu_torch.data.collate import collate
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, STROBE_HAN_CONFIGS["han-4"]))
    pr = np.float32([-51.2, -51.2, -5.0, 51.2, 51.2, 3.0])
    meta = dict(shape=np.asarray([STROBE_GRID, STROBE_GRID, 1]), range=pr,
                size=np.float32([CELL, CELL, 8.0]))
    rng = np.random.RandomState(12)
    samples, jaxs = [], []
    for _ in range(2):
        n = 14
        rho, phi = rng.uniform(5, 45, n), rng.uniform(-np.pi, np.pi, n)
        phi[:2] = [-np.pi / 2, 0.0]
        boxes = np.zeros((n, 9), np.float32)
        boxes[:, 0], boxes[:, 1] = rho * np.cos(phi), rho * np.sin(phi)
        boxes[:, 2] = rng.uniform(-1, 1, n)
        boxes[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
        boxes[:, 6:8] = rng.randn(n, 2)
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, n)
        classes = rng.randint(1, 11, n)
        outs = []
        for pkg in ("partner_tpu_torch", "partner_tpu"):
            mod = importlib.import_module(f"{pkg}.data.pipeline")
            res = {"mode": "train", "lidar": {
                "voxels": dict(meta), "annotations": {
                    "gt_boxes": boxes.copy(), "gt_classes": classes.copy()}}}
            outs.append(mod.AssignLabel(dict(
                cfg["train_cfg"]["assigner"], nsectors=nsectors))(
                res, {})[0]["lidar"]["targets"])
        got, want = outs
        assert sorted(got) == sorted(want)
        for k in want:
            for g, w in (zip(got[k], want[k]) if isinstance(want[k], list)
                         else [(got[k], want[k])]):
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)
        side = {2: (STROBE_GRID // 2 // 4, STROBE_GRID // 4),
                4: (STROBE_GRID // 2 // 4, STROBE_GRID // 2 // 4)}[nsectors]
        assert got["hm"][0].shape == (nsectors, 10) + side
        assert int(got["mask"][0].sum()) == n - {2: 1, 4: 2}[nsectors]
        samples.append(dict(got, points=np.zeros((5, 7), np.float32)))
        jaxs.append(want)
    batch = collate(samples, max_points=8)
    for k in ("hm", "anno_box", "ind", "mask", "cat"):
        want = np.stack([j[k][0] for j in jaxs])
        if k == "hm":
            want = want.transpose(0, 1, 3, 4, 2)
        assert batch[k][0].shape[:2] == (2, nsectors)
        np.testing.assert_array_equal(batch[k][0], want, err_msg=k)


# ------------------------------------------------------------- full width

FULL = {"han-1": ("PointPillarsModule", 32768, (512, 512), "RPN"),
        "han-4": ("PolarStreamLSTMModule", 7504, (256, 256),
                  "RPNWaymoLSTM"),
        "strobe-1": ("StrobeModule", 30000, (512, 512), "RPNUber"),
        "strobe-4": ("StrobeSectorModule", 7504, (256, 256), "RPNUber")}


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_builds_with_jax_parameter_count(name):
    """Each config at full width on the meta device: the module, its
    pillar capacity (HAN 1-sector's PointPillars factory keeps 32,768,
    not reading ``max_voxel_num``; the STROBE and HAN sector factories'
    rule gives 30,000 at one sector and 7,504 a sector at four), the
    pillar grid of a sector, the neck (``RPNWaymo`` builds
    ``RPNWaymoLSTM``; its ``memory.gates`` conv 256 -> 512 with a bias,
    the sector LSTM of 128 features, ``RPNUber``'s first conv on 256
    channels), STROBE's ``input_kind`` "sweeps", and every leaf's name and
    shape equal to ``jax.eval_shape`` of the JAX detector's init."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, STROBE_HAN_CONFIGS[name]))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    mod = det.module
    kind, cap, grid, neck = FULL[name]
    assert type(mod).__name__ == kind and mod.max_pillars == cap
    g = mod.sector_grid() if hasattr(mod, "sector_grid") else mod.grid_size
    assert tuple(g[:2]) == grid
    assert type(mod.neck).__name__ == neck
    assert det.input_kind == ("sweeps" if name.startswith("strobe")
                              else "points")
    sd = mod.state_dict()
    if name == "han-4":
        assert tuple(sd["neck.memory.gates.weight"].shape) == (512, 256, 3, 3)
        assert "neck.memory.gates.bias" in sd
        assert tuple(sd["lstm.if.weight"].shape) == (128, 128)
        assert "lstm.hf.bias" in sd and "lstm.if.bias" not in sd
        assert mod.sector_range()[3:5] == (0.0, 0.0)
    if name.startswith("strobe"):
        assert tuple(sd["neck.block0_conv0.weight"].shape) == (128, 256, 3, 3)
    ex = {"points": np.zeros((1, 2, 64, 7) if name.startswith("strobe")
                             else (1, 64, 7), np.float32)}
    ex["points_mask"] = np.zeros(ex["points"].shape[:-1], bool)
    shapes = jax.eval_shape(lambda: jax_build(
        cfg["model"], cfg["train_cfg"], cfg["test_cfg"]).module.init(
        jax.random.PRNGKey(0), ex, train=False))
    want = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
    assert sorted(want) == sorted(sd)
    for k, x in sd.items():
        assert tuple(want[k].shape) == tuple(x.shape), k


def test_fresh_lstm_init_and_names():
    """A fresh port HAN 4-sector module draws the sector LSTM as flax
    does: the recurrent kernels orthogonal, the input kernels lecun
    normal, every bias 0, the ConvLSTM's bias 0; ``PointPillarsLSTM`` and
    ``PointPillarsLSTMV1`` build the same module, ``PointPillarsNoLSTM``
    the plain PolarStream one, on the same parameters less the LSTM."""
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_strobe_cfg(STROBE_HAN_CONFIGS["han-4"])
    mods = {}
    for name in ("PointPillarsLSTMV1", "PointPillarsLSTM",
                 "PointPillarsNoLSTM"):
        mods[name] = build_detector(dict(copy.deepcopy(m), type=name), None,
                                    tc, device="cpu").module
    lstm = mods["PointPillarsLSTMV1"].lstm
    for g in "ifgo":
        w = getattr(lstm, f"h{g}").weight.detach()
        np.testing.assert_allclose((w @ w.T).numpy(), np.eye(16), atol=1e-5)
        assert float(getattr(lstm, f"h{g}").bias.abs().max()) == 0.0
        assert getattr(lstm, f"i{g}").bias is None
        wi = getattr(lstm, f"i{g}").weight.detach().numpy()
        assert abs(wi.std() * np.sqrt(16) - 1) < 0.35
    assert float(mods["PointPillarsLSTMV1"].neck.memory.gates.bias.abs()
                 .max()) == 0.0
    assert type(mods["PointPillarsLSTM"]) is type(mods["PointPillarsLSTMV1"])
    assert type(mods["PointPillarsNoLSTM"]).__name__ == "PolarStreamModule"
    a = set(mods["PointPillarsLSTMV1"].state_dict())
    assert {k for k in a if not k.startswith("lstm.")} == set(
        mods["PointPillarsNoLSTM"].state_dict())
