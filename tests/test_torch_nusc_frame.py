"""The nuScenes CenterPoint configs in partner_tpu_torch against the JAX
package (CPU, float32): the frame.

``configs/nusc/voxelnet/nusc_centerpoint_voxelnet_{dcn,01voxel,dcn_flip}.py``
cut by ``tests/torch_port_fixtures.py`` (the tiny grid, a narrow RPN, the
six tasks and their heads kept), on batches of a synthetic nuScenes set
made by the port's data path (``NUSC_SWEEPS`` sweeps a frame): the head
maps, and ``predict``'s kept boxes, labels and scores; the double-flip
config on its B x 4 rows, at two samples against the jitted JAX
``predict`` and at one sample against the JAX steps with the flip average
run op by op (its jitted form is wrong there on the CPU, ROADMAP.md §3).
The train step is held in ``tests/test_torch_nusc_train.py``, the entry
points in ``tests/test_torch_nusc_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (NUSC_CONFIGS as CONFIGS, load_converted,
                                 nusc_batch, nusc_jax_variables,
                                 tiny_centerpoint_cfg, write_tiny_nusc_set)

torch.set_num_threads(2)

KEYS = ("box3d_lidar", "scores", "label_preds", "mask")


@pytest.fixture(scope="module")
def nusc_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_frame"))
    return root, write_tiny_nusc_set(root)


@pytest.fixture(scope="module")
def frame_of(nusc_set):
    """``frame_of(name)``: both packages' frame of one config on the same
    two-sample val batch, made once a module -> (name, config cuts, JAX
    maps, JAX detections, port maps, port detections, the batch, the JAX
    detector, its variables, the port detector)."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _frame(name, *nusc_set)
        return made[name]

    return get


@pytest.fixture(params=list(CONFIGS))
def frames(request, frame_of):
    return frame_of(request.param)


def _frame(name, root, info):
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_centerpoint_cfg(CONFIGS[name])
    batch = nusc_batch(CONFIGS[name], m, info, root, "val", 2)
    ex = {k: batch[k] for k in ("points", "points_mask")}
    jdet = jax_build(m, None, tc)
    v = nusc_jax_variables(jdet, np.random.RandomState(1))
    jmaps, jout = jax.jit(lambda v, e: (
        jdet.module.apply(v, e, train=False), jdet.predict(v, e)))(v, ex)
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    tex = {k: torch.from_numpy(a) for k, a in ex.items()}
    with torch.no_grad():
        tmaps = tdet.module(tex)
    tout = tdet.predict(tex)
    as_np = lambda d: {k: np.asarray(x) for k, x in d.items()}
    return (name, (m, tc), [as_np(t) for t in jmaps["det_preds"]],
            as_np(jout), [as_np(t) for t in tmaps["det_preds"]],
            as_np(tout), ex, jdet, v, tdet)


def test_frame_head_maps_match_jax(frames):
    name, _, jmaps, _, tmaps, _, ex, *_ = frames
    assert len(tmaps) == len(jmaps) == 6
    rows = 8 if name == "dcn-flip" else 2
    assert ex["points"].shape[0] == rows
    for task, (t, j) in enumerate(zip(tmaps, jmaps)):
        assert list(t) == list(j) == ["dim", "height", "hm", "reg", "rot",
                                      "vel"]
        for k in j:
            assert t[k].shape[0] == rows
            # stem, 3D trunk, RPN and (deformable) head in f32, another
            # summation order
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"task{task} {k}")


def assert_detections_equal(tout, jout, n_rows):
    # six tasks of 64 kept slots, concatenated
    assert tout["mask"].shape == jout["mask"].shape == (n_rows, 384)
    assert tout["box3d_lidar"].shape[-1] == 9
    assert tout["mask"].sum() > 50   # score_threshold 0: NMS did real work
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    m = jout["mask"]
    # each task's labels offset by the classes of the tasks before it
    for task, lo, hi in ((0, 0, 0), (1, 1, 2), (2, 3, 4), (3, 5, 5),
                         (4, 6, 7), (5, 8, 9)):
        lab = tout["label_preds"][:, 64 * task:64 * (task + 1)]
        assert lab.min() >= lo and lab.max() <= hi, task
    np.testing.assert_allclose(tout["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                               rtol=1e-5, atol=1e-6)


def test_frame_detections_match_jax(frames):
    """Kept sets, their order and labels exact; for the flip config the
    two samples' maps averaged over their four copies first."""
    _, _, _, jout, _, tout, *_ = frames
    assert_detections_equal(tout, jout, 2)


def test_one_sample_flip_frame_matches_jax_op_by_op(frame_of):
    """The flip config at one sample (4 rows), the batch a serving frame
    and ``dist_test --batch_size 1`` hand it: the port's ``predict`` against
    the JAX package's steps (the jitted maps, then ``double_flip_average``,
    ``center_head_decode`` and ``center_head_post_process`` op by op)."""
    from partner_tpu.models.center_head import (center_head_decode,
                                                center_head_post_process,
                                                double_flip_average)

    _, (_, tc), jmaps, _, _, _, ex, jdet, _, tdet = frame_of("dcn-flip")
    outs, offset = [], 0
    for task in jmaps:
        avg = double_flip_average({k: jnp.asarray(a[:4])
                                   for k, a in task.items()})
        hm = avg["hm"]
        boxes, scores = center_head_decode(
            avg, (hm.shape[1], hm.shape[2]), jdet.voxel_size,
            jdet.module.pc_range, jdet.module.out_size_factor,
            voxel_shape="cuboid", pre_activated=True)
        outs.append(center_head_post_process(boxes, scores, tc,
                                             class_offset=offset))
        offset += hm.shape[-1]
    want = {k: np.concatenate([np.asarray(o[k]) for o in outs], 1)
            for k in KEYS}
    got = tdet.predict({k: torch.from_numpy(a[:4]) for k, a in ex.items()})
    assert_detections_equal({k: v.numpy() for k, v in got.items()}, want, 1)
