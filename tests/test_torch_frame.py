"""The whole inference slice: partner_tpu_torch against the JAX package.

``build_detector`` from a tiny, exactly tiling variant of the flagship
config (float32) on both sides, the JAX weights randomized and converted,
then ``predict`` on the same synthetic sweep. The frame is computed once
per module; each test compares one stage of it.
"""

import numpy as np
import pytest
import torch

from torch_port_fixtures import (load_converted, randomize, synthetic_points,
                                 tiny_frame_cfg)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frame():
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    rng = np.random.RandomState(0)
    model_cfg, test_cfg = tiny_frame_cfg()
    pc_range = model_cfg["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_points(rng, pc_range, 2000, 2400)
    jdet = jax_build(model_cfg, None, test_cfg)
    v = jdet.init(jax.random.PRNGKey(0), {"points": pts[:, :64],
                                          "points_mask": mask[:, :64]})
    v = randomize(v, rng)
    ex = {"points": pts, "points_mask": mask}
    jmaps = jax.jit(lambda v, e: jdet.module.apply(v, e, train=False))(v, ex)
    jout = jax.jit(jdet.predict)(v, ex)

    tdet = build_detector(model_cfg, None, test_cfg, device="cpu")
    load_converted(tdet.module, v)
    tex = {"points": torch.from_numpy(pts),
           "points_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        tmaps = tdet.module(tex)
    tout = tdet.predict(tex)
    as_np = lambda d: {k: np.asarray(x) for k, x in d.items()}
    return as_np(jmaps), {k: x.numpy() for k, x in tmaps.items()}, \
        as_np(jout), {k: x.numpy() for k, x in tout.items()}


def test_head_maps_match(frame):
    jmaps, tmaps, _, _ = frame
    assert sorted(tmaps) == sorted(jmaps)
    for k in jmaps:
        assert tmaps[k].shape == jmaps[k].shape
        # backbone, SetBlock, RPN and head in f32, another summation order
        np.testing.assert_allclose(tmaps[k], jmaps[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_nms_keeps_same_boxes(frame):
    _, _, jout, tout = frame
    assert tout["mask"].shape == jout["mask"].shape == (1, 64)
    assert tout["mask"].sum() > 10  # score_threshold 0: NMS did real work
    # the kept set and its order are exact
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])


def test_decoded_boxes_and_scores_match(frame):
    _, _, jout, tout = frame
    m = jout["mask"]
    # decode of the maps above (exp/atan2 in f32); boxes reach ~75 m
    np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tout["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-4, atol=1e-4)
