"""The Waymo val data path: partner_tpu_torch.data against partner_tpu.data.

Infos made as ``tests/test_data_pipeline.py`` makes them (pre-materialized
points), and path-based infos with sweeps from ``tools/create_data.py``;
the flagship ``test_pipeline`` on both sides must give bit-equal collated
batches. The epoch samplers give the same shards; what is not ported
(nuScenes, sector targets, seg labels) raises. Host (``hard``)
voxelization is held in ``tests/test_torch_voxelize.py``. The train mode
is held in ``tests/test_torch_train_data.py``.
"""

import copy
import os
import pickle
import sys

import numpy as np
import pytest

from test_data_pipeline import make_waymo_infos
from torch_port_fixtures import FLAGSHIP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def val_cfg(info_path, root, nsweeps=1):
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, FLAGSHIP))
    val = copy.deepcopy(cfg["data"]["val"])
    val.update(info_path=info_path, root_path=root, nsweeps=nsweeps)
    return val


def batches(data_pkg, val, batch_size, max_points):
    """{token: (batch, row)} over one pass of the package's loader."""
    ds = data_pkg.build_dataset(copy.deepcopy(val))
    loader = data_pkg.loader.DataLoader(ds, batch_size, shuffle=False,
                                        num_workers=2, max_points=max_points)
    out = {}
    for b in loader:
        for i, meta in enumerate(b["metadata"]):
            out[meta["token"]] = (b, i)
    return ds, out


def assert_batches_equal(val, batch_size, max_points):
    import partner_tpu.data as jdata
    import partner_tpu.data.loader  # noqa: F401
    import partner_tpu_torch.data as tdata
    import partner_tpu_torch.data.loader  # noqa: F401

    jds, jb = batches(jdata, val, batch_size, max_points)
    tds, tb = batches(tdata, val, batch_size, max_points)
    assert len(tds) == len(jds) and sorted(tb) == sorted(jb)
    for token in jb:
        (j, ji), (t, ti) = jb[token], tb[token]
        for k in ("points", "points_mask"):
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k][ti], j[k][ji], err_msg=k)
        assert sorted(t) == sorted(j)
        for k in ("grid_size", "pc_range", "voxel_size"):
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["metadata"][ti] == j["metadata"][ji]
    return tds


@pytest.mark.parametrize("batch_size,max_points", [(1, 6000), (2, 4000)])
def test_val_batches_bit_equal(tmp_path, batch_size, max_points):
    info_path = make_waymo_infos(tmp_path, n=5, seed=1)
    ds = assert_batches_equal(val_cfg(info_path, str(tmp_path)), batch_size,
                              max_points)
    assert len(ds) == 5


def test_val_batches_from_files_with_sweeps(tmp_path):
    """Path-based infos (the Waymo branch's file reads) with two sweeps,
    one of them moved by a transform matrix."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import create_data
    from test_create_data import _write_waymo_fixture

    root = str(tmp_path)
    _write_waymo_fixture(root, np.random.RandomState(2), n_frames=4)
    path = create_data.waymo_data_prep(root, "train", nsweeps=2,
                                       max_sweeps=1)
    with open(path, "rb") as f:
        infos = pickle.load(f)
    tm = np.eye(4)
    tm[:3, 3] = [0.5, -1.0, 0.1]
    infos[-1]["sweeps"][0]["transform_matrix"] = tm
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    ds = assert_batches_equal(val_cfg(path, root, nsweeps=2), 1, 3000)
    assert ds[1]["points"].shape[1] == 8  # + the time-lag column


@pytest.mark.parametrize("n,hosts,batch", [(10, 2, 1), (7, 2, 2), (9, 3, 2)])
def test_samplers_give_the_same_shards(n, hosts, batch):
    from partner_tpu.data.loader import EpochSampler as JEpoch
    from partner_tpu_torch.data.loader import EpochSampler

    for host in range(hosts):
        for shuffle in (True, False):
            a = EpochSampler(n, batch, shuffle, hosts, host, seed=3)
            b = JEpoch(n, batch, shuffle, hosts, host, seed=3)
            for epoch in range(3):
                np.testing.assert_array_equal(a.indices(epoch),
                                              b.indices(epoch))


def test_what_is_not_ported_raises(tmp_path):
    from partner_tpu_torch.data import pipeline
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, FLAGSHIP))
    with pytest.raises(NotImplementedError, match="nuScenes"):
        pipeline.LoadPointCloudFromFile(dataset="NuScenesDataset")
    with pytest.raises(NotImplementedError, match="PolarStream"):
        pipeline.AssignLabel(dict(cfg["assigner"], nsectors=2))
    with pytest.raises(NotImplementedError, match="seg_head"):
        pipeline.Preprocess(cfg["train_preprocessor"],
                            super_tasks=["det", "seg"])


@pytest.mark.parametrize("voxel_shape", ["cylinder", "cuboid"])
def test_box_np_ops_match(voxel_shape):
    from partner_tpu.core import box_np_ops as jb
    from partner_tpu_torch.core import box_np_ops as tb

    rng = np.random.RandomState(6)
    pts = rng.uniform(-40, 40, (500, 5)).astype(np.float32)
    np.testing.assert_array_equal(tb.transform_points(pts, voxel_shape),
                                  jb.transform_points(pts, voxel_shape))
    boxes = np.concatenate([rng.uniform(-40, 40, (30, 3)),
                            rng.uniform(1, 6, (30, 3)),
                            rng.uniform(-4, 4, (30, 1))], 1)
    np.testing.assert_array_equal(tb.limit_period(boxes[:, -1]),
                                  jb.limit_period(boxes[:, -1]))
    polar, cart = [0.3, -3.14, 30.0, 1.0], [-20.0, -10.0, 25.0, 30.0]
    np.testing.assert_array_equal(tb.filter_gt_polar_range(boxes, polar),
                                  jb.filter_gt_polar_range(boxes, polar))
    np.testing.assert_array_equal(tb.filter_gt_cart_range(boxes, cart),
                                  jb.filter_gt_cart_range(boxes, cart))
    inside = tb.points_in_rbbox(pts[:, :3] / 4, boxes / [4, 4, 4, 1, 1, 1, 1])
    np.testing.assert_array_equal(inside, jb.points_in_rbbox_np(
        pts[:, :3] / 4, boxes / [4, 4, 4, 1, 1, 1, 1]))
    assert 0 < inside.sum() < inside.size
