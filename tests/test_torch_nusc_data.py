"""The nuScenes data path: partner_tpu_torch against partner_tpu (CPU).

A synthetic nuScenes set written as the loader reads it
(``chip_smoke.write_nusc_scene``: key-frame and sweep ``.bin`` files,
transform matrices, time lags, 9-column boxes of the ten classes, the
calibration), its infos made by the port's ``create_data
nuscenes_data_prep``. The JAX package draws the sweeps from the global
``np.random``; the port from the ``RandomState`` it is given, and
``np.random.seed(s)`` gives the stream of ``RandomState(s)``: every output
here must be bit-equal. The loader (sweeps drawn with and without
replacement, ``remove_close``, the time-lag column, ``n_key_points``),
``DoubleFlip`` -> ``Reformat`` -> ``collate``, ``NuScenesDataset[i]`` of the
configs' pipelines in train and val mode, and ``nuscenes_data_prep`` with
the nuScenes GT database against the JAX tool.
"""

import copy
import os
import pickle
import sys

import numpy as np
import pytest

from torch_port_fixtures import NUSC_DCN, NUSC_FLIP, TINY_GRID

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """4 frames of ~1,500 points and 2 earlier sweeps each -> (root, the
    infos' path, the infos)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    root = str(tmp_path_factory.mktemp("nusc"))
    path = chip_smoke.write_nusc_scene(root, np.random.RandomState(3), 4, 3,
                                       1500, n_boxes=12)
    with open(path, "rb") as f:
        return root, path, pickle.load(f)


@pytest.mark.parametrize("nsweeps", [1, 2, 3, 5],
                         ids=["key-only", "one-of-two", "both", "replace"])
def test_loader_bit_equal(scene, nsweeps):
    """The key frame and ``nsweeps - 1`` drawn sweeps: without replacement
    while there are enough, with it past that (5 asks for 4 of 2)."""
    from partner_tpu.data import pipeline as jp
    from partner_tpu_torch.data import pipeline as tp

    _, _, infos = scene
    np.random.seed(7)
    jload = jp.LoadPointCloudFromFile(dataset="NuScenesDataset")
    tload = tp.LoadPointCloudFromFile(dataset="NuScenesDataset",
                                      rng=np.random.RandomState(7))
    for info in infos:
        res = lambda: {"lidar": {"nsweeps": nsweeps}, "mode": "val"}
        j, _ = jload(res(), info)
        t, _ = tload(res(), info)
        jpts, tpts = j["lidar"]["points"], t["lidar"]["points"]
        assert tpts.dtype == jpts.dtype == np.float32
        np.testing.assert_array_equal(tpts, jpts)
        n_key = t["lidar"]["n_key_points"]
        assert n_key == j["lidar"]["n_key_points"] == len(
            np.fromfile(info["lidar_path"], np.float32)) // 5
        assert tpts.shape[1] == 5 and not tpts[:n_key, 4].any()
        if nsweeps > 1:
            lags = set(np.unique(tpts[n_key:, 4]).tolist())
            assert lags <= {np.float32(0.05), np.float32(0.1)} and lags
            # remove_close: no sweep point within the 1 m square
            near = (np.abs(tpts[n_key:, 0]) < 1) & (np.abs(tpts[n_key:, 1])
                                                    < 1)
            assert not near.any()
        else:
            assert len(tpts) == n_key
    # the key frames keep their returns off the ego vehicle
    assert (np.abs(tpts[:n_key, :2]) < 1).all(1).any()


def test_sweep_reader_pieces_bit_equal(scene):
    from partner_tpu.data import pipeline as jp
    from partner_tpu_torch.data import pipeline as tp

    sweep = scene[2][1]["sweeps"][1]
    for got, want in zip(tp.read_sweep(sweep), jp.read_sweep(sweep)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    raw = tp.read_file(sweep["lidar_path"]).T
    np.testing.assert_array_equal(tp.remove_close(raw, 1.0),
                                  jp.remove_close(raw, 1.0))
    assert tp.remove_close(raw, 1.0).shape[1] < raw.shape[1]


def _cfg(config, info_path, root, mode):
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, config))
    ds = copy.deepcopy(cfg["data"][mode])
    ds.update(info_path=info_path, root_path=root, nsweeps=3)
    for p in ds["pipeline"]:
        if p["type"] == "Voxelization":
            vg = p["cfg"]
            r = vg["range"]
            vg["voxel_size"] = [(r[3 + i] - r[i]) / TINY_GRID[i]
                                for i in range(3)]
    return ds


TARGET_KEYS = ("hm", "anno_box", "ind", "mask", "cat", "global_box",
               "global_box_mask", "votemap_flat")


def _items_bit_equal(config, scene, mode, seed, batch=2):
    """Every item of the config's ``mode`` pipeline on both sides with one
    seed, in order, then collated ``batch`` at a time -> the port's
    batches."""
    import partner_tpu.data as jdata
    from partner_tpu.data.collate import collate as jcollate
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.collate import collate as tcollate

    root, path, _ = scene
    ds = _cfg(config, path, root, mode)
    np.random.seed(seed)
    jds = jdata.build_dataset(copy.deepcopy(ds))
    tds = tdata.build_dataset(copy.deepcopy(ds),
                              dict(rng=np.random.RandomState(seed)))
    assert type(tds).__name__ == "NuScenesDataset"
    assert tds.NumPointFeatures == jds.NumPointFeatures == 4
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    out = []
    for i in range(0, len(titems), batch):
        j = jcollate(jitems[i:i + batch], max_points=8000)
        t = tcollate(titems[i:i + batch], max_points=8000)
        assert sorted(t) == sorted(j)
        for k in t:
            if k == "metadata":
                assert t[k] == j[k]
                continue
            for jt, tt in (zip(j[k], t[k]) if isinstance(j[k], list)
                           else [(j[k], t[k])]):
                assert tt.dtype == jt.dtype, k
                np.testing.assert_array_equal(tt, jt, err_msg=k)
        out.append(t)
    return titems, out


def test_val_items_bit_equal(scene):
    """The DCN config's test_pipeline (cylinder layout, 7 columns): the
    sweeps drawn in val mode too, ``n_key_points`` in the metadata."""
    titems, batches = _items_bit_equal(NUSC_DCN, scene, "val", 12)
    assert batches[0]["points"].shape == (2, 8000, 7)
    for t in titems:
        assert t["metadata"]["n_key_points"] > 1000
        assert "hm" not in t


def test_train_items_bit_equal(scene):
    """The DCN config's train_pipeline: flips, rotation, scaling and the
    point shuffle drawn after the sweeps from the one stream, then the gt
    range filter and the six tasks' center targets."""
    titems, batches = _items_bit_equal(NUSC_DCN, scene, "train", 13)
    assert len(batches[0]["hm"]) == 6
    assert sum(int(m.sum()) for m in batches[0]["mask"]) > 5
    assert batches[0]["global_box"].shape[-1] == 10   # 9 columns + class


def test_double_flip_items_bit_equal(scene):
    """The flip config's test_pipeline: ``DoubleFlip`` after the cuboid
    layout, ``Reformat(double_flip=True)``, and ``collate`` putting each
    sample's four copies in consecutive rows."""
    titems, batches = _items_bit_equal(NUSC_FLIP, scene, "val", 14)
    b = batches[0]
    assert b["points"].shape == (8, 8000, 7) and len(b["metadata"]) == 2
    for i in range(2):
        orig, y, x, xy = (b["points"][4 * i + j] for j in range(4))
        np.testing.assert_array_equal(y[:, 1], -orig[:, 1])
        np.testing.assert_array_equal(x[:, 0], -orig[:, 0])
        np.testing.assert_array_equal(xy[:, :2], -orig[:, :2])
        np.testing.assert_array_equal(y[:, 2:], orig[:, 2:])
        assert (b["points_mask"][4 * i:4 * i + 4]
                == b["points_mask"][4 * i]).all()


def test_data_prep_and_gt_database_bit_equal(scene, tmp_path):
    """``nuscenes_data_prep`` from the frames pkl (calibration passed
    through) and ``create_groundtruth_database`` over the nuScenes key
    frames, against ``tools/create_data.py`` writing into its own root."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import create_data as jtool
    from partner_tpu_torch.tools import create_data as ttool

    root, _, _ = scene
    frames = os.path.join(root, "frames.pkl")
    outs = {}
    for name, run in (("jax", lambda r: (
            jtool.nuscenes_data_prep(r, "v1.0-mini-val", 10, frames),
            jtool.create_groundtruth_database)),
            ("port", lambda r: (
                ttool.main(["nuscenes_data_prep", "--root_path", r,
                            "--version", "v1.0-mini-val", "--frames_pkl",
                            frames]),
                lambda *a: ttool.main(["create_groundtruth_database",
                                       "--dataset", a[0], "--root_path",
                                       a[1], "--info_path", a[2]])))):
        r = str(tmp_path / name)
        os.makedirs(r)
        info_path, db = run(r)
        assert os.path.basename(info_path) == (
            "infos_val_10sweeps_withvelo_filter_True.pkl")
        db_path = db("NuScenesDataset", r, info_path)
        with open(info_path, "rb") as f, open(db_path, "rb") as g:
            outs[name] = (pickle.load(f), pickle.load(g), r)
    (jinfos, jdb, jroot), (tinfos, tdb, troot) = outs["jax"], outs["port"]
    assert len(tinfos) == len(jinfos) == 4
    for j, t in zip(jinfos, tinfos):
        assert sorted(t) == sorted(j)
        assert "ego2global_rotation" in t and len(t["sweeps"]) == 2
        for k in j:
            if isinstance(j[k], np.ndarray):
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            elif k == "sweeps":
                for js, ts in zip(j[k], t[k]):
                    np.testing.assert_array_equal(ts["transform_matrix"],
                                                  js["transform_matrix"])
                    assert ts["lidar_path"] == js["lidar_path"]
                    assert ts["time_lag"] == js["time_lag"]
            else:
                assert t[k] == j[k], k
    assert sorted(tdb) == sorted(jdb) and sum(map(len, tdb.values())) > 20
    for cls in jdb:
        for j, t in zip(jdb[cls], tdb[cls]):
            assert sorted(t) == sorted(j)
            np.testing.assert_array_equal(t["box3d_lidar"], j["box3d_lidar"])
            assert all(t[k] == j[k] for k in j if k != "box3d_lidar")
            with open(os.path.join(troot, t["path"]), "rb") as f, open(
                    os.path.join(jroot, j["path"]), "rb") as g:
                assert f.read() == g.read()


def test_data_prep_refuses_what_the_jax_tool_refuses(tmp_path):
    from partner_tpu_torch.tools import create_data

    with pytest.raises(FileNotFoundError, match="frames pkl"):
        create_data.nuscenes_data_prep(str(tmp_path))
    sys.modules["nuscenes"] = type(sys)("nuscenes")
    sys.modules["nuscenes"].NuScenes = object
    try:
        with pytest.raises(NotImplementedError, match="devkit"):
            create_data.nuscenes_data_prep(str(tmp_path))
    finally:
        del sys.modules["nuscenes"]
