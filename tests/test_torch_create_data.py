"""The port's Waymo data preparation against the JAX package's tool (CPU).

``partner_tpu_torch.tools.create_data`` (converter, info builder, GT
database builder) and ``partner_tpu_torch.data.waymo_decoder`` against
``tools/create_data.py`` and ``partner_tpu/data/waymo_decoder.py`` on the
same synthetic inputs, made from a seed: the converted lidar and anno
pkls, the info pkl and every database file byte for byte, the dbinfos pkl
equal, and the TFRecord framing reader on a hand-framed file.
"""

import os
import pickle
import shutil
import struct
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import create_data as jax_create_data  # noqa: E402
from test_create_data import _write_waymo_fixture  # noqa: E402
from test_waymo_decoder import _fake_frame  # noqa: E402


def _files(directory):
    """{name: bytes} of every file under ``directory``."""
    out = {}
    for base, _, names in os.walk(directory):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, directory)] = f.read()
    return out


def _frames(rng, n, seq):
    """Fake frames (``tests/test_waymo_decoder.py``'s) of one sequence:
    varied labels (types 1, 2 and 4; one frame with none), some no-label
    zone returns, a second return, and (sequence 0) the TOP lidar's
    per-pixel pose, so the rolling-shutter path runs."""
    frames = []
    for i in range(n):
        fr = _fake_frame(rng, n_labels=0 if (seq, i) == (1, 1) else 3,
                         nlz_frac=0.2)
        fr["timestamp_micros"] += 100000 * i
        for j, lab in enumerate(fr["laser_labels"]):
            lab["type"] = (1, 2, 4)[j % 3]
            lab["id"] = f"seq{seq}_obj{j}"
        laser = fr["lasers"][0]
        ri2 = laser["ri_return1"]["range_image"].copy()
        ri2[..., 0] *= rng.uniform(0.9, 1.1, ri2.shape[:2])
        laser["ri_return2"] = {"range_image": ri2}
        if seq == 0:
            pose = np.zeros(ri2.shape[:2] + (6,))
            pose[..., :3] = rng.normal(0, 0.01, pose[..., :3].shape)
            pose[..., 3:] = rng.normal(0, 0.5, pose[..., 3:].shape)
            laser["ri_return1"]["range_image_pose_compressed"] = pose
            t = np.eye(4)
            t[:3, 3] = [10.0 * i, 1.0, 0.0]
            fr["pose"] = {"transform": list(t.ravel())}
        frames.append(fr)
    return frames


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Two fake-frame records (3 and 2 frames) converted by each package
    into its own root -> {"jax": root, "port": root}."""
    tmp = tmp_path_factory.mktemp("convert")
    rng = np.random.RandomState(3)
    for seq, n in ((0, 3), (1, 2)):
        with open(tmp / f"rec_{seq}.pkl", "wb") as f:
            pickle.dump(_frames(rng, n, seq), f)
    from partner_tpu_torch.tools import create_data

    roots = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    jax_create_data.waymo_convert(str(tmp / "rec_*.pkl"), roots["jax"],
                                  "train")
    got = create_data.main(["waymo_convert", "--record_path",
                            str(tmp / "rec_*.pkl"), "--root_path",
                            roots["port"], "--split", "train"])
    assert got == os.path.join(roots["port"], "train", "lidar")
    return roots


def test_waymo_convert_matches_jax(converted):
    """Every lidar and anno pkl byte for byte."""
    want, got = _files(converted["jax"]), _files(converted["port"])
    assert sorted(got) == sorted(want)
    assert len(want) == 10 and "train/lidar/seq_1_frame_1.pkl" in want
    for name in want:
        assert got[name] == want[name], name
    with open(os.path.join(converted["port"], "train", "lidar",
                           "seq_0_frame_0.pkl"), "rb") as f:
        lidar = pickle.load(f)["lidars"]
    # both returns, the no-label-zone points dropped
    assert 64 < len(lidar["points_xyz"]) < 128


@pytest.mark.parametrize("split,max_sweeps", [("train", 0), ("train", 2),
                                              ("val", 1)])
def test_waymo_data_prep_matches_jax(converted, split, max_sweeps, tmp_path):
    """The info pkl of each package over the same converted frames: the
    same infos in the same order, each with the same keys in the same
    order, equal values and ``np.array_equal`` arrays of one dtype; a
    train split drops the frame with no box. With ``max_sweeps`` 0 both
    list every earlier frame of the sequence as a sweep (``hist[-0:]``,
    ROADMAP.md §3)."""
    from partner_tpu_torch.tools import create_data

    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(converted["port"], "train"),
                    os.path.join(root, split))
    want_path = jax_create_data.waymo_data_prep(root, split, 1, max_sweeps)
    with open(want_path, "rb") as f:
        want = pickle.load(f)
    os.remove(want_path)
    got_path = create_data.waymo_data_prep(root, split, 1, max_sweeps)
    assert got_path == want_path
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    assert len(want) == (4 if split == "train" else 5)
    assert [i["token"] for i in got] == [i["token"] for i in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        if not max_sweeps:
            assert len(g["sweeps"]) == int(g["token"][-1])
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    assert list(want[0]["gt_names"]) == ["Vehicle", "Pedestrian", "Cyclist"]
    assert max(len(i["sweeps"]) for i in got) == (max_sweeps or 2)
    assert all(i["sweeps"] == [] for i in got if i["token"].endswith("_0"))


@pytest.mark.parametrize("used_classes", [None, ["Vehicle"]])
def test_gt_database_matches_jax(used_classes, tmp_path):
    """``create_groundtruth_database`` over the fixture of
    ``tests/test_create_data.py``: every ``gt_database/*.bin`` byte for
    byte and the dbinfos pkl equal (names, paths, boxes, point counts,
    difficulty)."""
    from partner_tpu_torch.tools import create_data

    out = {}
    for side, prep, build in (
            ("jax", jax_create_data.waymo_data_prep,
             jax_create_data.create_groundtruth_database),
            ("port", create_data.waymo_data_prep,
             create_data.create_groundtruth_database)):
        root = str(tmp_path / side)
        _write_waymo_fixture(root, np.random.RandomState(4), n_frames=4)
        info_path = prep(root, "train", nsweeps=1)
        db_path = build("WaymoDataset", root, info_path, used_classes)
        with open(db_path, "rb") as f:
            out[side] = (pickle.load(f), _files(os.path.join(root,
                                                             "gt_database")))
    (want_db, want_bins), (got_db, got_bins) = out["jax"], out["port"]
    assert sorted(got_bins) == sorted(want_bins) and len(want_bins) == 8
    for name in want_bins:
        assert got_bins[name] == want_bins[name], name
    assert list(got_db) == list(want_db) == ["Vehicle"]
    for g, w in zip(got_db["Vehicle"], want_db["Vehicle"]):
        assert list(g) == list(w)
        np.testing.assert_array_equal(g["box3d_lidar"], w["box3d_lidar"])
        assert g["box3d_lidar"].dtype == w["box3d_lidar"].dtype
        for k in ("name", "path", "num_points_in_gt", "difficulty"):
            assert g[k] == w[k], k
    assert min(e["num_points_in_gt"] for e in got_db["Vehicle"]) >= 150


def test_tfrecord_framing_reader(tmp_path):
    """Length-prefixed records round trip, an empty one included, and
    both readers agree."""
    from partner_tpu_torch.tools import create_data

    payloads = [b"hello", b"x" * 300, b"", bytes(range(256))]
    path = str(tmp_path / "t.tfrecord")
    with open(path, "wb") as f:
        for p in payloads:
            f.write(struct.pack("<Q", len(p)))
            f.write(b"\0" * 4)
            f.write(p)
            f.write(b"\0" * 4)
    assert list(create_data._read_tfrecord(path)) == payloads
    assert list(jax_create_data._read_tfrecord(path)) == payloads


def test_decoder_matches_jax(rng):
    """The numpy decoder's pieces on random inputs, the rolling-shutter
    path included: exactly the JAX package's outputs."""
    from partner_tpu.data import waymo_decoder as jwd
    from partner_tpu_torch.data import waymo_decoder as wd

    ri = np.zeros((6, 20, 4))
    ri[..., 0] = rng.rand(6, 20) * 50
    ri[..., 1:3] = rng.rand(6, 20, 2)
    ri[..., 3] = (rng.rand(6, 20) < 0.1) * 1.0
    ext = np.eye(4)
    ext[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    ext[:3, 3] = rng.randn(3)
    incl = wd.compute_inclination(-0.3, 0.2, 6)[::-1]
    pp = np.tile(np.eye(4), (6, 20, 1, 1))
    pp[..., :3, 3] = rng.randn(6, 20, 3)
    frame_pose = np.eye(4)
    frame_pose[:3, 3] = rng.randn(3)
    for args in ((ri, ext, incl), (ri, ext, incl, pp, frame_pose)):
        np.testing.assert_array_equal(wd.decode_range_image(*args),
                                      jwd.decode_range_image(*args))
    objs = _fake_frame(rng, n_labels=4)["laser_labels"]
    rot = ext[:3, :3]
    for g, w in zip(wd.extract_objects(objs, rot),
                    jwd.extract_objects(objs, rot)):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert wd.NAME_BY_TYPE == jwd.NAME_BY_TYPE


def test_unported_subcommands_exit(tmp_path):
    from partner_tpu_torch.tools import create_data

    with pytest.raises(SystemExit) as e:
        create_data.main(["nuscenes_data_prep"])
    assert str(e.value) == create_data.NOT_PORTED
    with pytest.raises(SystemExit) as e:
        create_data.create_groundtruth_database(
            "NuScenesDataset", str(tmp_path), str(tmp_path / "x.pkl"))
    assert str(e.value) == create_data.NOT_PORTED
    assert "NuScenesDataset" in create_data.NOT_PORTED
