"""The two-stage CenterPoint in partner_tpu_torch against the JAX package
(CPU, float32): its modules and ``predict``.

The Waymo two-stage configs (``TwoStageDetector`` around the one-stage
``VoxelNet``) with the first stage cut to the tiny grid and a narrow RPN
(``torch_port_fixtures.tiny_two_stage_cfg``): the sampling, the bilinear
BEV gather, the RoI targets and residuals, the RoI head and ``refine``
from one converted parameter tree, ``predict`` of both configs, both
configs built at full width, and the refusals. The train steps are held
in ``tests/test_torch_two_stage_train.py``, the entry points in
``tests/test_torch_two_stage_cli.py``.
"""

import os

import functools

import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import (TWO_STAGE, TWO_STAGE_VELO, load_converted,
                                 randomize, synthetic_points,
                                 tiny_two_stage_cfg)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"one-sweep": TWO_STAGE, "two-sweep-velo": TWO_STAGE_VELO}
PC_RANGE = (0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0)   # the Waymo configs'


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _boxes(rng, n, spread=40.0):
    """(n, 7) boxes within the range, 1-5 m sides, any yaw."""
    b = np.zeros((n, 7), np.float32)
    rho, phi = rng.uniform(2, spread, n), rng.uniform(-np.pi, np.pi, n)
    b[:, 0], b[:, 1] = rho * np.cos(phi), rho * np.sin(phi)
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(1, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


# ------------------------------------------------------- the pure functions

def test_box_sample_points_matches_jax(rng):
    from partner_tpu.models.two_stage import box_sample_points as jfn
    from partner_tpu_torch.models.two_stage import box_sample_points

    boxes = _boxes(rng, 300)
    vel = np.concatenate([boxes[:, :6], rng.randn(300, 2).astype(np.float32),
                          boxes[:, 6:]], 1)        # yaw last, 9 columns
    for b in (boxes, vel, boxes.reshape(3, 100, 7)):
        got = box_sample_points(t(b)).numpy()
        want = np.asarray(jax.jit(jfn)(b))
        assert got.shape == want.shape == b.shape[:-1] + (5, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _targets_inputs(rng, n=96, m=12):
    """Proposals of which half jitter a gt box (positives), gts with a
    class column, and a mask that drops the last few gts."""
    gt = _boxes(rng, m)
    props = _boxes(rng, n)
    near = rng.randint(0, m, n // 2)
    props[: n // 2] = gt[near]
    props[: n // 2, :2] += rng.uniform(-0.3, 0.3, (n // 2, 2))
    props[: n // 2, 3:6] *= rng.uniform(0.85, 1.15, (n // 2, 3))
    props[: n // 2, 6] += rng.uniform(-0.2, 0.2, n // 2) + np.where(
        rng.rand(n // 2) < 0.3, 2 * np.pi, 0.0)  # some wrap the yaw
    props[3] = gt[0]                              # an exact duplicate
    gt8 = np.concatenate([gt, rng.randint(1, 4, (m, 1)).astype(np.float32)],
                         1)
    mask = np.ones(m, bool)
    mask[-3:] = False
    return props.astype(np.float32), gt8, mask


def test_proposal_targets_and_residuals_match_jax(rng):
    """The positives exactly equal, the targets within a float32 rounding
    of the IoU and residuals (bounds below), per sample and batched (JAX
    vmaps the per-sample function); ``apply_residuals`` of random residuals
    within 1e-5 (boxes up to 40 m, an exp of each side)."""
    from partner_tpu.models.two_stage import apply_residuals as japply
    from partner_tpu.models.two_stage import proposal_targets as jtargets
    from partner_tpu_torch.models.two_stage import (apply_residuals,
                                                    proposal_targets)

    batch = [_targets_inputs(rng) for _ in range(3)]
    props, gt8, mask = (np.stack(x) for x in zip(*batch))
    want = jax.jit(jax.vmap(jtargets))(props, gt8, mask)
    got = proposal_targets(t(props), t(gt8), t(mask))
    iou_t, reg_t, pos = (np.asarray(w) for w in want)
    assert 20 < pos.sum() < pos.size
    np.testing.assert_array_equal(got[2].numpy(), pos)
    # the IoU is Green's sum of 8 cross products of up to ~5 m^2 with
    # cancellation, and torch's sin / cos round another way than XLA's in
    # ~5% of arguments: measured 4.2e-6 at most on the target (2 x IoU)
    np.testing.assert_allclose(got[0].numpy(), iou_t, rtol=0, atol=1e-5)
    # an unmatched proposal's residuals reach ~20 (the offset to gt 0 over
    # the proposal's diagonal), where a float32 ulp is 1.9e-6
    np.testing.assert_allclose(got[1].numpy(), reg_t, rtol=1e-6, atol=1e-6)
    one = proposal_targets(t(props[1]), t(gt8[1]), t(mask[1]))
    for a, b in zip(one, got):
        np.testing.assert_array_equal(a.numpy(), b[1].numpy())

    reg = rng.normal(0, 0.3, props.shape).astype(np.float32)
    np.testing.assert_allclose(apply_residuals(t(props), t(reg)).numpy(),
                               np.asarray(jax.jit(japply)(props, reg)),
                               rtol=0, atol=1e-5)


def test_green_area_matches_jax(rng):
    """The port's ``rect_intersection_area_green`` (trig computed inside)
    against the JAX package's, on random pairs, identical boxes and
    shared edges."""
    from partner_tpu.ops.rotated_iou import rect_intersection_area_green as j
    from partner_tpu_torch.ops.rotated_iou import rect_intersection_area_green

    a = _boxes(rng, 400, spread=6)[:, [0, 1, 3, 4, 6]]
    b = _boxes(rng, 400, spread=6)[:, [0, 1, 3, 4, 6]]
    b[:50] = a[:50]                          # identical
    b[50:100] = a[50:100]
    b[50:100, 0] += a[50:100, 2] * np.cos(a[50:100, 4])   # edge to edge
    b[50:100, 1] += a[50:100, 2] * np.sin(a[50:100, 4])
    got = rect_intersection_area_green(t(a), t(b)).numpy()
    want = np.asarray(jax.jit(j)(a, b))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:50], a[:50, 2] * a[:50, 3], rtol=1e-6)


@pytest.mark.parametrize("voxel_shape", ["cylinder", "cuboid"])
def test_bev_bilinear_sample_matches_jax(rng, voxel_shape):
    """The four-corner gather against ``map_coordinates(order=1,
    mode="constant")``, on a random map with points inside, off the map on
    every side, at cell centers, and (polar grid) at the azimuth wrap, phi
    near +-pi: all within 1e-6 relative or 5e-6 absolute."""
    from partner_tpu.models.two_stage import bev_bilinear_sample as jfn
    from partner_tpu_torch.models.two_stage import bev_bilinear_sample

    n_az, n_r, c = 24, 16, 5
    bev = rng.uniform(-1, 1, (n_az, n_r, c)).astype(np.float32)
    if voxel_shape == "cylinder":
        rho = np.concatenate([rng.uniform(0, 80, 400),          # some off
                              rng.uniform(1, 70, 200)])
        phi = np.concatenate([rng.uniform(-np.pi, np.pi, 400),
                              np.pi - rng.uniform(0, 0.2, 100),
                              -np.pi + rng.uniform(0, 0.2, 100)])
        # exact cell centers: the map's own values
        ci, cj = rng.randint(0, n_r, 20), rng.randint(0, n_az, 20)
        rho_c = PC_RANGE[0] + (ci + 0.5) * (PC_RANGE[3] - PC_RANGE[0]) / n_r
        phi_c = PC_RANGE[1] + (cj + 0.5) * (PC_RANGE[4] - PC_RANGE[1]) / n_az
        rho, phi = np.concatenate([rho, rho_c]), np.concatenate([phi, phi_c])
        pts = np.stack([rho * np.cos(phi), rho * np.sin(phi)], 1)
    else:
        pts = np.stack([rng.uniform(-10, 85, 620),
                        rng.uniform(-4.5, 4.5, 620)], 1)
    pts = pts.astype(np.float32)
    want = np.asarray(jax.jit(lambda b, p: jfn(
        b, p, PC_RANGE, 8, None, voxel_shape=voxel_shape))(bev, pts))
    got = bev_bilinear_sample(t(bev[None]), t(pts[None]), PC_RANGE,
                              voxel_shape)[0].numpy()
    assert got.shape == want.shape == (len(pts), c)
    assert (np.abs(want).sum(1) == 0).sum() > 5        # wholly off the map
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=5e-6)
    batched = bev_bilinear_sample(t(np.stack([bev, bev[::-1]])),
                                  t(np.stack([pts, pts])), PC_RANGE,
                                  voxel_shape).numpy()
    np.testing.assert_array_equal(batched[0], got)
    if voxel_shape == "cylinder":
        np.testing.assert_allclose(got[-20:], bev[cj, ci], rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------ module and detector

def _jax_init(jdet, c, rng):
    z = np.zeros((1, 64, c), np.float32)
    return randomize(jdet.init(jax.random.PRNGKey(0), {
        "points": z, "points_mask": np.zeros((1, 64), bool)}), rng)


def _pair(config=TWO_STAGE, freeze=False, seed=0):
    """Both packages' detector of one tiny config with one randomized
    parameter tree: (JAX detector, its variables, port detector, model
    cfg, test cfg)."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    rng = np.random.RandomState(seed)
    m, tc = tiny_two_stage_cfg(config, freeze=freeze)
    c = m["first_stage_cfg"]["backbone"]["num_input_features"]
    jdet = jax_build(m, None, tc)
    v = _jax_init(jdet, c, rng)
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    return jdet, v, tdet, m, tc


# the refine test and the frames fixture read, and never train, one pair
_read_only_pair = functools.lru_cache(maxsize=None)(_pair)


def test_refine_matches_jax(rng):
    """``RoIHead`` through ``TwoStageModule.refine`` from one converted
    tree: the same BEV map and proposals give IoU logits and residuals
    within 1e-5; the head's input is 5 x the BEV width + 1."""
    from partner_tpu.models.two_stage import TwoStageModule as JaxModule

    jdet, v, tdet, _, _ = _read_only_pair(TWO_STAGE)
    assert tdet.module.roi_head.Dense_0.weight.shape == (256, 5 * 64 + 1)
    bev = rng.normal(0, 1, (2, 32, 16, 64)).astype(np.float32)
    props = np.stack([_boxes(rng, 40, spread=70) for _ in range(2)])
    scores = rng.rand(2, 40).astype(np.float32)
    want = jax.jit(lambda v, *a: jdet.module.apply(
        v, *a, False, method=JaxModule.refine))(v, bev, props, scores)
    with torch.no_grad():
        got = tdet.module.refine(t(bev), t(props), t(scores))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module", params=list(CONFIGS))
def frames(request):
    """Both packages' ``predict`` of one config on the same sweep."""
    jdet, v, tdet, m, _ = _read_only_pair(CONFIGS[request.param])
    c = m["first_stage_cfg"]["backbone"]["num_input_features"]
    pts, mask = synthetic_points(np.random.RandomState(3), m[
        "first_stage_cfg"]["bbox_head"]["voxel_generator"]["range"], 2000,
        2400, c=c)
    ex = {"points": pts, "points_mask": mask}
    jout = jax.jit(jdet.predict)(v, ex)
    tout = tdet.predict({k: t(a) for k, a in ex.items()})
    as_np = lambda d: {k: np.asarray(x) for k, x in d.items()}
    return request.param, as_np(jout), as_np(tout)


def test_predict_matches_jax(frames):
    """The kept indices (mask and labels) exactly; the refined boxes
    within 1e-4 and the geometric-mean scores within 1e-4; velocity
    columns kept for the two-sweep config."""
    name, jout, tout = frames
    assert tout["mask"].shape == jout["mask"].shape == (1, 64)
    assert tout["box3d_lidar"].shape[-1] == (9 if "velo" in name else 7)
    assert tout["mask"].sum() > 10
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    m = jout["mask"]
    np.testing.assert_allclose(tout["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=0,
                               atol=1e-4)
    assert np.all(tout["scores"][~m] == 0)


# ---------------------------------------------------- build and refusals

@pytest.mark.parametrize("config", list(CONFIGS.values()),
                         ids=list(CONFIGS))
def test_every_two_stage_config_builds(config):
    """Both two-stage configs at full width and grid on the meta device:
    a frozen VoxelNet first stage (the one-stage config's, 7 or 8 input
    features), the RoI head 5 x 512 + 1 -> 256 -> 256 -> 1 and 7, the
    one-stage checkpoint it names, and the point path with the batch keys
    of a frozen loss."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.models.two_stage import TwoStageDetector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, config))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    assert isinstance(det, TwoStageDetector) and det.freeze
    assert det.input_kind == "points"
    assert det.pretrained == cfg["model"]["first_stage_cfg"]["pretrained"]
    mod = det.module
    assert mod.first.grid_size == (1152, 2048, 40)
    c_in = cfg["model"]["first_stage_cfg"]["backbone"][
        "num_input_features"] + 3
    assert tuple(mod.first.backbone.stem0_kernel.shape) == (c_in, 32)
    head = mod.roi_head
    assert tuple(head.Dense_0.weight.shape) == (256, 5 * 512 + 1)
    assert tuple(head.Dense_1.weight.shape) == (256, 256)
    assert tuple(head.cls_out.weight.shape) == (1, 256)
    assert tuple(head.reg_out.weight.shape) == (7, 256)
    assert not any(p.requires_grad for p in mod.first.parameters())
    assert all(p.requires_grad for p in mod.roi_head.parameters())
    mod.train()
    assert not mod.first.training and mod.roi_head.training


def test_two_stage_refusals():
    """A multi-task first stage, a non-VoxelNet first stage and the E2E
    head's block route each raise."""
    import copy

    from partner_tpu_torch.models import build_detector

    m, tc = tiny_two_stage_cfg()
    with pytest.raises(ValueError, match="use_block_kernel"):
        build_detector(m, None, tc, device="meta", use_block_kernel=True)
    two = copy.deepcopy(m)
    tasks = two["first_stage_cfg"]["bbox_head"]["tasks"]
    two["first_stage_cfg"]["bbox_head"]["tasks"] = [
        dict(num_class=1, class_names=["Vehicle"]),
        dict(num_class=2, class_names=["Pedestrian", "Cyclist"])]
    assert len(tasks) == 1
    with pytest.raises(NotImplementedError, match="task 0 only"):
        build_detector(two, None, tc, device="meta")
    from torch_port_fixtures import tiny_frame_cfg

    flagship, _ = tiny_frame_cfg()
    with pytest.raises(TypeError, match="CenterPoint-style"):
        build_detector(dict(m, first_stage_cfg=flagship), None, tc,
                       device="meta")
