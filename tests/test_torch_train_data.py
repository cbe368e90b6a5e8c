"""The train-mode data path: partner_tpu_torch against partner_tpu.

The JAX package draws from the global ``np.random``; the port from the
``np.random.RandomState`` it is given. A legacy ``RandomState(s)`` gives
the stream of ``np.random.seed(s)``, so with the same seed and the same
order of draws every output here must be bit-equal: the augmentations, the
collision test, GT-AUG's samples from a database written in the test, the
center targets on polar and cartesian grids, the collated batches of the
flagship ``train_pipeline`` with GT-AUG on, and the group sampler and the
dataset wrappers.
"""

import copy
import os
import pickle

import numpy as np
import pytest

from test_data_pipeline import make_waymo_infos
from torch_port_fixtures import FLAGSHIP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scene(rng, n_boxes=12, ncol=9, n_points=400):
    """Boxes [x, y, z, dx, dy, dz, (vx, vy,) yaw] and points [x, y, z, i, e]."""
    b = np.zeros((n_boxes, ncol))
    rho, phi = rng.uniform(5, 40, n_boxes), rng.uniform(-3, 3, n_boxes)
    b[:, 0], b[:, 1] = rho * np.cos(phi), rho * np.sin(phi)
    b[:, 2] = rng.uniform(-0.5, 0.5, n_boxes)
    b[:, 3:6] = rng.uniform(1.5, 5, (n_boxes, 3))
    if ncol > 7:
        b[:, 6:8] = rng.normal(0, 3, (n_boxes, 2))
    b[:, -1] = rng.uniform(-np.pi, np.pi, n_boxes)
    pts = rng.uniform(-40, 40, (n_points, 5)).astype(np.float32)
    return b.astype(np.float32), pts


AUGMENTATIONS = [
    ("random_flip_both", lambda f, b, p, rng: f(b, p, rng=rng)),
    ("random_flip_both", lambda f, b, p, rng: f(b, p, 0.3, rng=rng)),
    ("global_rotation", lambda f, b, p, rng: f(b, p, [-0.78, 0.78], rng=rng)),
    ("global_rotation", lambda f, b, p, rng: f(b, p, 0.5, rng=rng)),
    ("global_scaling", lambda f, b, p, rng: f(b, p, 0.95, 1.05, rng=rng)),
    ("global_translate", lambda f, b, p, rng: f(b, p, [0.2, 0.3, 0.0],
                                                  rng=rng)),
    ("global_translate", lambda f, b, p, rng: f(b, p, 0.0, rng=rng)),
]


@pytest.mark.parametrize("ncol", [7, 9])
@pytest.mark.parametrize("case", range(len(AUGMENTATIONS)))
def test_augmentation_bit_equal(case, ncol):
    from partner_tpu.data import augment as ja
    from partner_tpu_torch.data import augment as ta

    name, call = AUGMENTATIONS[case]
    for seed in range(4):   # both branches of each flip
        b, p = scene(np.random.RandomState(seed), ncol=ncol)
        jb, jp = call(getattr(ja, name), b.copy(), p.copy(),
                      np.random.RandomState(seed))
        tb, tp = call(getattr(ta, name), b.copy(), p.copy(),
                      np.random.RandomState(seed))
        assert tb.dtype == jb.dtype and tp.dtype == jp.dtype
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tp, jp)


def test_box_ops_and_collision_test_equal():
    from partner_tpu.core import box_np_ops as jbo
    from partner_tpu.data import augment as ja
    from partner_tpu_torch.core import box_np_ops as tbo
    from partner_tpu_torch.data import augment as ta

    rng = np.random.RandomState(3)
    b, _ = scene(rng, n_boxes=40, ncol=7)
    b[:, :2] /= 4   # crowd them so that some overlap
    args = (b[:, :2], b[:, 3:5], b[:, -1])
    jc, tc = jbo.center_to_corner_box2d(*args), tbo.center_to_corner_box2d(
        *args)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(
        tbo.center_to_corner_box3d(b[:, :3], b[:, 3:6], b[:, -1]),
        jbo.center_to_corner_box3d(b[:, :3], b[:, 3:6], b[:, -1]))
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(
            tbo.rotation_points_single_angle(b[:, :3], 0.7, axis),
            jbo.rotation_points_single_angle(b[:, :3], 0.7, axis))
    coll = ta.box_collision_test(tc, tc[:25])
    np.testing.assert_array_equal(coll, ja.box_collision_test_np(jc, jc[:25]))
    assert 0 < coll.sum() < coll.size
    assert ta.box_collision_test(tc[:0], tc).shape == (0, 40)


def write_db(root, rng, n_per_class=(("Vehicle", 30), ("Pedestrian", 8))):
    """A GT database as tools/create_data.py writes it: per object a float32
    (n, 5) .bin of points around the box center, and a dbinfos pkl."""
    db = {}
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    k = 0
    for name, n in n_per_class:
        boxes, _ = scene(rng, n_boxes=n)
        for box in boxes:
            npts = rng.randint(0, 40)
            pts = (rng.uniform(-0.5, 0.5, (npts, 5)) * np.r_[box[3:6], 1, 1]
                   ).astype(np.float32)
            rel = os.path.join("gt_database", f"{name}_{k}.bin")
            pts.tofile(os.path.join(root, rel))
            db.setdefault(name, []).append({
                "name": name, "path": rel, "box3d_lidar": box,
                "num_points_in_gt": npts,
                "difficulty": int(rng.choice([-1, 0, 0, 0]))})
            k += 1
    path = os.path.join(root, "dbinfos.pkl")
    with open(path, "wb") as f:
        pickle.dump(db, f)
    return path, db


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_database_sampler_equal(tmp_path, rate):
    from partner_tpu.data.gt_aug import DataBaseSampler as J
    from partner_tpu_torch.data.gt_aug import DataBaseSampler as T

    _, db = write_db(str(tmp_path), np.random.RandomState(4))
    groups = [dict(Vehicle=15), dict(Pedestrian=6)]
    prep = [dict(filter_by_min_num_points=dict(Vehicle=5)),
            dict(filter_by_difficulty=[-1])]
    np.random.seed(11)
    js = J(copy.deepcopy(db), groups, prep, rate)
    ts = T(copy.deepcopy(db), groups, prep, rate,
           rng=np.random.RandomState(11))
    rng = np.random.RandomState(5)
    inserted = 0
    for _ in range(6):   # enough calls for the class lists to wrap
        b, _ = scene(rng, n_boxes=int(rng.randint(0, 8)))
        names = np.array(["Vehicle"] * len(b))
        j = js.sample_all(str(tmp_path), b, names, 5)
        t = ts.sample_all(str(tmp_path), b, names, 5)
        assert (j is None) == (t is None)
        if j is None:
            continue
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        inserted += len(t["gt_boxes"])
    assert inserted > 20


@pytest.mark.parametrize("voxel_shape", ["cylinder", "cuboid"])
@pytest.mark.parametrize("rectify", [False, True])
def test_center_target_assigner_equal(voxel_shape, rectify):
    from partner_tpu.core.targets import CenterTargetAssigner as J
    from partner_tpu_torch.core.targets import CenterTargetAssigner as T

    tasks = [dict(num_class=1, class_names=["Vehicle"]),
             dict(num_class=2, class_names=["Pedestrian", "Cyclist"])]
    if voxel_shape == "cylinder":
        pc_range = np.array([0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0])
        grid = np.array([288, 512, 40])
    else:
        pc_range = np.array([-75.2, -75.2, -2.0, 75.2, 75.2, 4.0])
        grid = np.array([376, 376, 40])
    vs = (pc_range[3:] - pc_range[:3]) / grid
    rng = np.random.RandomState(8)
    boxes, _ = scene(rng, n_boxes=30)
    boxes[:3, 3:5] = 0.0    # degenerate extents are skipped
    boxes[3, :2] = [200.0, 0.0]   # off the grid
    classes = rng.randint(1, 4, len(boxes)).astype(np.int32)
    kw = dict(tasks=tasks, out_size_factor=8, gaussian_overlap=0.1,
              max_objs=24, min_radius=2, voxel_shape=voxel_shape,
              rectify=rectify)
    j = J(**kw).assign(boxes, classes, grid, vs, pc_range)
    t = T(**kw).assign(boxes, classes, grid, vs, pc_range)
    assert sorted(t) == sorted(j)
    for k in j:
        for jt, tt in zip(j[k], t[k]):
            assert tt.dtype == jt.dtype, k
            np.testing.assert_array_equal(tt, jt, err_msg=k)
    assert sum(int(m.sum()) for m in t["mask"]) > 10


def flagship_train_cfg(info_path, root, db_info_path):
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, FLAGSHIP))
    train = copy.deepcopy(cfg["data"]["train"])
    train.update(info_path=info_path, root_path=root)
    prep = train["pipeline"][2]["cfg"]
    prep["db_sampler"]["db_info_path"] = db_info_path
    return train


def write_infos_and_db(tmp_path):
    """make_waymo_infos frames, a Pedestrian among the Vehicles, and a GT
    database cut from them with the port's points_in_rbbox."""
    from partner_tpu_torch.core.box_np_ops import points_in_rbbox

    info_path = make_waymo_infos(tmp_path, n=6, seed=9)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    infos[1]["gt_names"][0] = "Pedestrian"
    db = {}
    os.makedirs(tmp_path / "gt_database")
    for i, info in enumerate(infos):
        b = info["gt_boxes"]
        inside = points_in_rbbox(info["points"][:, :3],
                                 np.concatenate([b[:, :6], b[:, -1:]], 1))
        for k, name in enumerate(info["gt_names"]):
            pts = info["points"][inside[:, k]].copy()
            pts[:, :3] -= b[k, :3]
            rel = f"gt_database/{name}_{i}_{k}.bin"
            pts.tofile(str(tmp_path / rel))
            db.setdefault(str(name), []).append({
                "name": str(name), "path": rel, "box3d_lidar": b[k],
                "num_points_in_gt": int(inside[:, k].sum()),
                "difficulty": 0})
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    db_path = str(tmp_path / "dbinfos.pkl")
    with open(db_path, "wb") as f:
        pickle.dump(db, f)
    return info_path, db_path


TARGET_KEYS = ("global_box", "global_box_mask", "votemap_flat", "hm",
               "anno_box", "ind", "mask", "cat")


def test_flagship_train_batches_bit_equal(tmp_path):
    """The flagship train_pipeline (GT-AUG, flips, rotation, scaling,
    shuffle) on both sides with one seed, item by item in order, collated
    in pairs."""
    import partner_tpu.data as jdata
    from partner_tpu.data.collate import collate as jcollate
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.collate import collate as tcollate

    info_path, db_path = write_infos_and_db(tmp_path)
    train = flagship_train_cfg(info_path, str(tmp_path), db_path)
    np.random.seed(21)
    jds = jdata.build_dataset(copy.deepcopy(train))
    tds = tdata.build_dataset(copy.deepcopy(train),
                              dict(rng=np.random.RandomState(21)))
    assert len(tds) == len(jds) == 6
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    n_boxes = [int((t["global_box"][:, -1] > 0).sum()) for t in titems]
    assert min(n_boxes) > 4, n_boxes   # GT-AUG inserted vehicles
    for i in range(0, 6, 2):
        j = jcollate(jitems[i:i + 2], max_points=8000)
        t = tcollate(titems[i:i + 2], max_points=8000)
        assert sorted(t) == sorted(j)
        for k in ("points", "points_mask") + TARGET_KEYS:
            for jt, tt in (zip(j[k], t[k]) if isinstance(j[k], list)
                           else [(j[k], t[k])]):
                assert tt.dtype == jt.dtype, k
                np.testing.assert_array_equal(tt, jt, err_msg=k)
        assert t["metadata"] == j["metadata"]
    # the Pedestrian is not a flagship class: filtered out, never a target
    assert all(set(np.unique(t["global_box"][:, -1])) <= {0.0, 1.0}
               for t in titems)


class _Sized:
    def __init__(self, n, flag=None):
        self.n = n
        if flag is not None:
            self.flag = np.asarray(flag)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (self.n, i)


def wrapped(pkg, spec):
    """ConcatDataset / RepeatDataset of _Sized sources from a spec."""
    ds = pkg.datasets
    parts = [_Sized(n, f) for n, f in spec["sources"]]
    out = ds.ConcatDataset(parts)
    if spec.get("times"):
        out = ds.RepeatDataset(out, spec["times"])
    return out


WRAPPER_SPECS = [
    dict(sources=[(5, None), (3, None)]),
    dict(sources=[(4, [0, 1, 1, 0]), (6, None), (2, [2, 0])], times=2),
    dict(sources=[(7, None)], times=3),
]


@pytest.mark.parametrize("spec", range(len(WRAPPER_SPECS)))
def test_dataset_wrappers_match(spec):
    import partner_tpu.data as jdata
    import partner_tpu_torch.data as tdata

    j, t = (wrapped(jdata, WRAPPER_SPECS[spec]),
            wrapped(tdata, WRAPPER_SPECS[spec]))
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.flag, j.flag)
    assert t.flag.dtype == j.flag.dtype
    assert [t[i] for i in range(len(t))] == [j[i] for i in range(len(j))]


@pytest.mark.parametrize("hosts,batch", [(1, 2), (2, 2), (3, 1)])
def test_group_sampler_and_loader_choice_match(hosts, batch):
    import partner_tpu.data as jdata
    from partner_tpu.data.loader import DataLoader as JLoader
    from partner_tpu.data.loader import GroupSampler as JGroup
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.loader import DataLoader as TLoader
    from partner_tpu_torch.data.loader import GroupSampler as TGroup

    flag = wrapped(jdata, WRAPPER_SPECS[1]).flag
    for host in range(hosts):
        a = TGroup(flag, batch, hosts, host, seed=3)
        b = JGroup(flag, batch, hosts, host, seed=3)
        assert a.num_samples == b.num_samples
        for epoch in range(3):
            idx = a.indices(epoch)
            np.testing.assert_array_equal(idx, b.indices(epoch))
            groups = flag[idx].reshape(-1, batch)
            assert (groups == groups[:, :1]).all()   # one group a batch
    for spec, group in ((WRAPPER_SPECS[1], True), (WRAPPER_SPECS[2], False)):
        t = TLoader(wrapped(tdata, spec), batch, num_workers=1)
        j = JLoader(wrapped(jdata, spec), batch, num_workers=1)
        assert isinstance(t.sampler, TGroup) == isinstance(
            j.sampler, JGroup) == group
        np.testing.assert_array_equal(t.sampler.indices(1),
                                      j.sampler.indices(1))


def test_build_dataset_builds_wrapped_configs(tmp_path):
    import partner_tpu_torch.data as tdata

    info_path = make_waymo_infos(tmp_path, n=3, seed=2)
    one = dict(type="WaymoDataset", root_path=str(tmp_path),
               info_path=info_path, pipeline=[], class_names=["Vehicle"])
    rep = tdata.build_dataset(dict(type="RepeatDataset", dataset=one,
                                   times=2))
    cat = tdata.build_dataset(dict(type="ConcatDataset", datasets=[
        one, dict(one, load_interval=2)]))
    assert len(rep) == 6 and len(cat) == 5
    np.testing.assert_array_equal(cat.flag, [0, 0, 0, 1, 1])


def test_gt_aug_sampler_shared_by_threads_loses_no_draw():
    """The loader's threads share each class's BatchSampler: 16 threads
    drawing one entry at a time, 80 whole cycles in all, get every entry
    exactly 80 times."""
    import sys
    import threading

    from partner_tpu_torch.data.gt_aug import BatchSampler

    n, cycles, n_threads = 7, 80, 16
    sampler = BatchSampler(list(range(n)), rng=np.random.RandomState(0))
    got, lock = [], threading.Lock()

    def draw():
        mine = [sampler.sample(1)[0] for _ in range(n * cycles // n_threads)]
        with lock:
            got.extend(mine)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=draw) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert np.bincount(got, minlength=n).tolist() == [cycles] * n


def test_loader_threads_end_when_the_consumer_stops_early():
    """A capped epoch stops reading with batches still queued: the worker
    threads give up rather than block on the full queue."""
    import threading
    import time

    from partner_tpu_torch.data.loader import DataLoader

    before = threading.active_count()
    loader = DataLoader(_Sized(64), 2, shuffle=False, num_workers=4,
                        prefetch=1, collate_fn=list)
    it = iter(loader)
    assert len(next(it)) == 2
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
