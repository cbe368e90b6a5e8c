"""partner_tpu_torch's CenterPoint head against the JAX package (CPU, f32).

``CenterHead`` maps with converted, randomized weights; ``fast_focal_loss``
and ``reg_loss``; ``center_head_loss``; ``center_head_decode`` on both grid
shapes; ``center_head_post_process``. Every input is made with numpy from
a seed and handed to both packages.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (CENTERPOINT, CENTERPOINT_VELO, jax_apply,
                                 jax_init, load_converted, randomize)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUSC = "configs/nusc/voxelnet/nusc_centerpoint_voxelnet_01voxel.py"


def _head_cfg(config):
    """The config's bbox_head rewritten as ``build_voxelnet`` rewrites it
    in both packages (tasks as tuples, common_heads sorted, detector keys
    taken out)."""
    from partner_tpu_torch.utils.config import load_config

    bh = copy.deepcopy(load_config(os.path.join(ROOT, config))["model"][
        "bbox_head"])
    for k in ("voxel_shape", "code_weights", "weight", "dataset",
              "voxel_generator"):
        bh.pop(k, None)
    bh["tasks"] = tuple({"class_names": tuple(t["class_names"])}
                        for t in bh["tasks"])
    bh["common_heads"] = tuple(sorted((k, tuple(v)) for k, v in
                                      bh["common_heads"].items()))
    return bh


# one task without vel (Waymo one sweep), one with vel (Waymo two sweeps),
# the 6-task, 10-class nuScenes head (its 01voxel config sets dcn_head False)
HEADS = {"waymo": CENTERPOINT, "waymo-vel": CENTERPOINT_VELO, "nusc": NUSC}


@pytest.mark.parametrize("case", list(HEADS))
def test_center_head_maps_match_jax(rng, case):
    from partner_tpu.models import registry as jreg
    from partner_tpu_torch.models import registry as treg

    hc = _head_cfg(HEADS[case])
    x = rng.randn(2, 16, 12, hc["in_channels"]).astype(np.float32)
    jhead = jreg.build_from_cfg(dict(hc), jreg.BBOX_HEADS)
    v = randomize(jax_init(jhead, x, train=False), rng)
    ref = jax_apply(jhead, v, x, train=False)["det_preds"]
    thead = load_converted(treg.build_from_cfg(dict(hc), treg.BBOX_HEADS), v)
    with torch.no_grad():
        out = thead(torch.from_numpy(x))["det_preds"]
    assert len(out) == len(ref) == len(hc["tasks"])
    for task, (o, r) in enumerate(zip(out, ref)):
        # the heads in flax's sorted order
        assert list(o) == list(r) == sorted(r)
        for k in r:
            # two 3x3 f32 convs (and the shared one): summation order only
            np.testing.assert_allclose(o[k].numpy(), r[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"task{task} {k}")


def test_dcn_head_raises_with_its_roadmap_item():
    from partner_tpu_torch.models.center_head import CenterHead

    with pytest.raises(NotImplementedError, match="deform_conv"):
        CenterHead(tasks=({"class_names": ("car",)},), dcn_head=True)


def _targets(rng, b, h, w, ncls, m=12, n_pos=7):
    """Per-task targets as the assigner gives them: hm (B, H, W, C) with
    peaks of 1, anno_box (B, M, 10), ind / mask / cat (B, M)."""
    hm = (rng.rand(b, h, w, ncls) ** 4).astype(np.float32)
    ind = np.stack([rng.choice(h * w, m, replace=False) for _ in range(b)])
    cat = rng.randint(0, ncls, (b, m))
    mask = np.zeros((b, m), np.uint8)
    mask[:, :n_pos] = 1
    for i in range(b):
        for j in range(n_pos):
            hm[i, ind[i, j] // w, ind[i, j] % w, cat[i, j]] = 1.0
    anno = rng.randn(b, m, 10).astype(np.float32)
    return hm, anno, ind.astype(np.int64), mask, cat.astype(np.int64)


@pytest.mark.parametrize("n_pos", [7, 0], ids=["positives", "no-positives"])
def test_fast_focal_and_reg_loss_match_jax(rng, n_pos):
    from partner_tpu.losses import centernet as jc
    from partner_tpu_torch.losses import centernet as tc

    hm, anno, ind, mask, cat = _targets(rng, 2, 8, 6, 3, n_pos=n_pos)
    out = np.clip(1 / (1 + np.exp(-rng.randn(*hm.shape))), 1e-4,
                  1 - 1e-4).astype(np.float32)
    reg = rng.randn(2, 8, 6, 10).astype(np.float32)
    t = lambda *a: [torch.from_numpy(x) for x in a]
    got = tc.fast_focal_loss(*t(out, hm, ind, mask, cat))
    want = jc.fast_focal_loss(*(jnp.asarray(a) for a in (out, hm, ind, mask,
                                                          cat)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got = tc.reg_loss(*t(reg, mask, ind, anno))
    want = jc.reg_loss(*(jnp.asarray(a) for a in (reg, mask, ind, anno)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def _maps(rng, heads, b=2, h=8, w=6):
    return {name: rng.randn(b, h, w, c).astype(np.float32)
            for name, c in heads}


HEADS_NO_VEL = (("dim", 3), ("height", 1), ("hm", 3), ("reg", 2), ("rot", 2))
HEADS_VEL = HEADS_NO_VEL + (("vel", 2),)


@pytest.mark.parametrize("vel", [False, True], ids=["no-vel", "vel"])
def test_center_head_loss_matches_jax(rng, vel):
    from partner_tpu.models.center_head import center_head_loss as jloss
    from partner_tpu_torch.models.center_head import center_head_loss

    preds = [_maps(rng, HEADS_VEL if vel else HEADS_NO_VEL) for _ in range(2)]
    targets = [_targets(rng, 2, 8, 6, 3) for _ in range(2)]
    ex = {k: [t[i] for t in targets]
          for i, k in enumerate(("hm", "anno_box", "ind", "mask", "cat"))}
    cw = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0] if vel else \
        [1.0] * 8
    want = jloss({"det_preds": [{k: jnp.asarray(a) for k, a in p.items()}
                                for p in preds]},
                 {k: [jnp.asarray(a) for a in v] for k, v in ex.items()},
                 cw, 2.0)
    got = center_head_loss(
        {"det_preds": [{k: torch.from_numpy(a) for k, a in p.items()}
                       for p in preds]},
        {k: [torch.from_numpy(a) for a in v] for k, v in ex.items()}, cw,
        2.0)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("det_loss", "hm_loss", "loc_loss"):
        assert len(got[k]) == len(want[k]) == 2
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                       err_msg=k)


WAYMO_RANGE = (0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0)
# (voxel shape, rectify, pc_range, voxel size) on an 8 x 6 map, stride 8
DECODES = {
    "cylinder": ("cylinder", False, WAYMO_RANGE, (1.17, 0.0982, 0.15)),
    "cylinder-rectify": ("cylinder", True, WAYMO_RANGE, (1.17, 0.0982, 0.15)),
    "cuboid": ("cuboid", False, (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
               (1.6, 1.2, 0.15)),
}


@pytest.mark.parametrize("case", list(DECODES))
def test_center_head_decode_matches_jax(rng, case):
    from partner_tpu.models.center_head import center_head_decode as jdec
    from partner_tpu_torch.models.center_head import center_head_decode

    shape, rectify, pcr, vs = DECODES[case]
    preds = _maps(rng, HEADS_VEL)
    preds["dim"] *= 4  # some past the +-8 clip
    args = ((8, 6), vs, pcr, 8, shape, rectify)
    jb, js = jdec({k: jnp.asarray(a) for k, a in preds.items()}, *args)
    tb, ts = center_head_decode({k: torch.from_numpy(a)
                                 for k, a in preds.items()}, *args)
    assert tb.shape == jb.shape == (2, 48, 9)
    # exp / atan2 / hypot in f32, XLA against torch: ulps
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_center_head_post_process_matches_jax(rng):
    """Two tasks' decoded boxes through the score / range mask and the
    rotated NMS: kept indices (the boxes gathered), labels with the class
    offset, and masks exactly equal."""
    from partner_tpu.models.center_head import \
        center_head_post_process as jpost
    from partner_tpu_torch.models.center_head import center_head_post_process

    tc = dict(score_threshold=0.3,
              post_center_limit_range=[-30, -30, -10, 30, 30, 10],
              nms=dict(nms_pre_max_size=64, nms_post_max_size=48,
                       nms_iou_threshold=0.5))
    for offset, (n, ncls) in ((0, (96, 1)), (1, (96, 3))):
        # clustered boxes: the NMS suppresses; some out of range
        centers = rng.uniform(-35, 35, (2, 12, 2))[:, rng.randint(0, 12, n)]
        boxes = np.concatenate([
            centers + rng.randn(2, n, 2) * 0.2, rng.randn(2, n, 1),
            rng.uniform(1, 5, (2, n, 3)), rng.randn(2, n, 2),
            rng.uniform(-np.pi, np.pi, (2, n, 1))], -1).astype(np.float32)
        scores = rng.rand(2, n, ncls).astype(np.float32)
        scores[:, :4] = scores[:, :4, :1]       # argmax ties: lower class
        want = jpost(jnp.asarray(boxes), jnp.asarray(scores), tc,
                     class_offset=offset)
        got = center_head_post_process(torch.from_numpy(boxes),
                                       torch.from_numpy(scores), tc,
                                       class_offset=offset)
        assert 0 < int(got["mask"].sum()) < 2 * 48
        for k in ("box3d_lidar", "scores", "label_preds", "mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


def test_post_process_options_not_ported_raise():
    from partner_tpu_torch.models.center_head import center_head_post_process

    with pytest.raises(NotImplementedError, match="batched_rotated_nms"):
        center_head_post_process(torch.zeros(1, 4, 7), torch.zeros(1, 4, 1),
                                 {"per_class_nms": True})
