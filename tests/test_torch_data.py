"""The Waymo val data path: partner_tpu_torch.data against partner_tpu.data.

Infos made as ``tests/test_data_pipeline.py`` makes them (pre-materialized
points), and path-based infos with sweeps from ``tools/create_data.py``;
the flagship ``test_pipeline`` on both sides must give bit-equal collated
batches. The epoch samplers give the same shards; what is not ported
(sector targets, seg labels) raises. The nuScenes data path is held in
``tests/test_torch_nusc_data.py``. Host (``hard``)
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
    # the nuScenes loader is ported (tests/test_torch_nusc_data.py), its
    # seg labels too (tests/test_torch_seg.py): a seg loader keeps its
    # super_tasks; a dataset the port does not know raises
    assert pipeline.LoadPointCloudFromFile(
        dataset="NuScenesDataset").type == "NuScenesDataset"
    assert pipeline.LoadPointCloudFromFile(
        dataset="NuScenesDataset",
        super_tasks=["det", "seg"]).super_tasks == ["det", "seg"]
    with pytest.raises(NotImplementedError, match="KittiDataset"):
        pipeline.LoadPointCloudFromFile(dataset="KittiDataset")
    # cylinder sector targets are ported (PolarStream): two sectors of
    # the flagship's grid, every target equal to JAX's
    from partner_tpu.data.pipeline import AssignLabel as JaxAssignLabel

    vg = cfg["voxel_generator"]
    pr = np.asarray(vg["range"], np.float32)
    size = np.asarray(vg["voxel_size"], np.float32)
    shape = np.round((pr[3:] - pr[:3]) / size).astype(np.int64)
    rng = np.random.RandomState(2)
    rho, phi = rng.uniform(5, 60, 8), rng.uniform(-3, 3, 8)
    phi[0] = 0.0                       # on the edge of the two sectors
    boxes = np.stack([rho * np.cos(phi), rho * np.sin(phi),
                      rng.uniform(-1, 1, 8), rng.uniform(1, 5, 8),
                      rng.uniform(1, 3, 8), rng.uniform(1, 2, 8),
                      rng.uniform(-3, 3, 8)], 1).astype(np.float32)
    outs = []
    for cls in (pipeline.AssignLabel, JaxAssignLabel):
        res = {"mode": "train", "lidar": {
            "voxels": dict(shape=shape, range=pr, size=size),
            "annotations": {"gt_boxes": boxes.copy(),
                            "gt_classes": np.ones(8, np.int64)}}}
        outs.append(cls(dict(cfg["assigner"], nsectors=2))(res, {})[0][
            "lidar"]["targets"])
    got, want = outs
    assert sorted(got) == sorted(want)
    assert got["hm"][0].shape[0] == 2 and int(got["mask"][0].sum()) == 8
    for k in want:
        for g, w in (zip(got[k], want[k]) if isinstance(want[k], list)
                     else [(got[k], want[k])]):
            np.testing.assert_array_equal(g, w, err_msg=k)
    # the cuboid sectors (cartesian wedges), once a raise naming queue 1
    # item 7, are ported (HAN, STROBE; held against JAX on their grids in
    # tests/test_torch_strobe.py): on the flagship's grid, every target
    # equal to JAX's too
    outs = []
    for cls in (pipeline.AssignLabel, JaxAssignLabel):
        res = {"mode": "train", "lidar": {
            "voxels": dict(shape=shape, range=pr, size=size),
            "annotations": {"gt_boxes": boxes.copy(),
                            "gt_classes": np.ones(8, np.int64)}}}
        outs.append(cls(dict(cfg["assigner"], nsectors=2,
                             voxel_shape="cuboid"))(res, {})[0][
            "lidar"]["targets"])
    got, want = outs
    assert sorted(got) == sorted(want) and got["hm"][0].shape[0] == 2
    for k in want:
        for g, w in (zip(got[k], want[k]) if isinstance(want[k], list)
                     else [(got[k], want[k])]):
            np.testing.assert_array_equal(g, w, err_msg=k)
    # a seg Preprocess splits the label column off after the shuffle, as
    # JAX's does; without the loader's seg_labeled mark it keeps every
    # column
    from partner_tpu.data.pipeline import Preprocess as JaxPreprocess

    pts = rng.uniform(-20, 20, (50, 6)).astype(np.float32)
    pts[:, -1] = rng.randint(-1, 17, 50)
    pre_cfg = dict(cfg["train_preprocessor"], shuffle_points=True,
                   no_augmentation=True, db_sampler=None)
    outs = []
    for labelled in (True, False):
        for pre in (pipeline.Preprocess(pre_cfg,
                                        rng=np.random.RandomState(4),
                                        super_tasks=["det", "seg"]),
                    JaxPreprocess(pre_cfg, super_tasks=["det", "seg"])):
            np.random.seed(4)
            res = {"mode": "train", "metadata": {}, "lidar": {
                "points": pts.copy(), "seg_labeled": labelled,
                "annotations": {"boxes": boxes[:0], "names": np.array([])}}}
            outs.append(pre(res, {})[0]["lidar"])
    for got, want in (outs[:2], outs[2:]):
        assert ("pc_label" in got) == ("pc_label" in want)
        np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(outs[0]["pc_label"], outs[1]["pc_label"])
    assert outs[0]["points"].shape[1] == outs[2]["points"].shape[1] - 1


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
