"""Detectors on the sparse backbone (SpMiddleResNetFHD) of partner_tpu_torch
against the JAX package (CPU, float32, tiny grid and widths).

- PARTNER (``VoxelNetV3``, both head routes) and CenterPoint (``VoxelNet``)
  with ``backbone`` replaced by ``SpMiddleResNetFHD``: head maps at 1e-4
  and kept NMS indices exactly. On ``features`` from ``dynamic_voxelize``
  (rows sorted by cell id) against JAX's default ``"binary"`` backbone; on
  hard ``voxels`` (first-come rows) against JAX's backbone with
  ``index_method="dense"``, because JAX's ``"binary"`` method is wrong on
  unsorted rows (ROADMAP.md §3);
- the two-stage CenterPoint over a sparse first stage;
- ``python -m partner_tpu_torch.tools.dist_test --input voxels`` from a
  ``modelzoo://`` name, each frame bit-equal to a direct ``predict``;
- the builders' ``input_kind``, and a train step or ``tools.train`` run of
  a sparse config stopping at once.
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from test_data_pipeline import make_waymo_infos
from test_torch_voxelize import _voxel_inputs
from torch_port_fixtures import (CENTERPOINT, SPARSE_BEV, TWO_STAGE,
                                 load_converted, randomize, synthetic_points,
                                 tiny_centerpoint_cfg, tiny_frame_cfg,
                                 tiny_two_stage_cfg, with_sparse_backbone,
                                 write_tiny_eval_config)

torch.set_num_threads(2)

MAX_VOXELS = 3000


def _cfg(config, index_method="binary"):
    m, tc = (tiny_frame_cfg() if config == "partner"
             else tiny_centerpoint_cfg(CENTERPOINT))
    return with_sparse_backbone(m, index_method), tc


@functools.lru_cache(maxsize=None)
def _case(config):
    """(model cfg, test cfg, points, mask, randomized JAX variables): one
    tree serves both JAX index methods (their parameters are the same)."""
    import jax

    from partner_tpu.models import build_detector as jax_build

    rng = np.random.RandomState(21)
    m, tc = _cfg(config)
    pts, mask = synthetic_points(rng, m["bbox_head"]["voxel_generator"][
        "range"], 2000, 2400)
    ex = _voxel_inputs(pts, mask, m, MAX_VOXELS, "features")
    v = jax_build(m, None, tc).init(jax.random.PRNGKey(0), ex)
    return m, tc, pts, mask, randomize(v, rng)


@pytest.fixture(scope="module",
                params=[(c, k) for c in ("partner", "centerpoint")
                        for k in ("features", "voxels")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def frames(request):
    """JAX's maps and detections of one config and input kind, and the
    port's on each head route."""
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    config, kind = request.param
    m, tc, pts, mask, v = _case(config)
    ex = _voxel_inputs(pts, mask, m, MAX_VOXELS, kind)
    if kind == "voxels":        # first-come rows: JAX's order-proof method
        jm, _ = _cfg(config, "dense")
    else:
        jm = m
    jdet = jax_build(jm, None, tc)
    jmaps, jout = jax.jit(lambda v, e: (
        jdet.module.apply(v, e, train=False), jdet.predict(v, e)))(v, ex)
    port = []
    for block in ([False, True] if config == "partner" else [False]):
        tdet = build_detector(m, None, tc, device="cpu",
                              use_block_kernel=block)
        assert tdet.input_kind == "voxels"
        load_converted(tdet.module, v)
        tex = {k: torch.from_numpy(a) for k, a in ex.items()}
        with torch.no_grad():
            tmaps = tdet.module(tex)
        port.append((tmaps, tdet.predict(tex)))
    return config, kind, ex, jmaps, jout, port


def _flat(maps):
    if "det_preds" in maps:
        return {f"task{i}/{k}": np.asarray(x)
                for i, t in enumerate(maps["det_preds"]) for k, x in t.items()}
    return {k: np.asarray(x) for k, x in maps.items()}


def test_rows_as_the_voxelizers_give_them(frames):
    """The dynamic voxelizer's rows are sorted by cell id, the hard
    voxelizer's are not: the case this file exists for."""
    _, kind, ex, _, _, _ = frames
    c, n = ex["coords"][0].astype(np.int64), ex["voxel_mask"][0].sum()
    lin = (c[:n, 0] * 1000 + c[:n, 1]) * 1000 + c[:n, 2]
    assert n > 500
    assert (np.all(np.diff(lin) > 0)) == (kind == "features")


def test_sparse_frame_maps_match_jax(frames):
    _, _, _, jmaps, _, port = frames
    want = _flat(jmaps)
    for tmaps, _ in port:
        got = _flat({k: ([{n: x.numpy() for n, x in t.items()} for t in val]
                         if k == "det_preds" else val.numpy())
                     for k, val in tmaps.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.abs(want[k]).max() > 0, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_sparse_frame_keeps_same_boxes(frames):
    _, _, _, _, jout, port = frames
    jout = {k: np.asarray(x) for k, x in jout.items()}
    m = jout["mask"]
    for _, tout in port:
        tout = {k: x.numpy() for k, x in tout.items()}
        assert tout["mask"].sum() > 10
        np.testing.assert_array_equal(tout["mask"], m)
        np.testing.assert_array_equal(tout["label_preds"],
                                      jout["label_preds"])
        np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tout["box3d_lidar"][m],
                                   jout["box3d_lidar"][m], rtol=1e-4,
                                   atol=1e-4)


def test_jax_checkpoint_of_sparse_model_loads(tmp_path):
    """A JAX ``state.pkl`` of a sparse-backbone detector loads through the
    port's JAX reader strictly, every tensor equal to ``flax_to_torch``'s."""
    from partner_tpu.train.checkpoint import save_checkpoint
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    m, tc, _, _, v = _case("centerpoint")

    class State:   # what the JAX save_checkpoint reads of a TrainState
        step, params, batch_stats, opt_state = 3, v["params"], \
            v["batch_stats"], {}

    path = save_checkpoint(str(tmp_path), State)
    payload, _ = load_checkpoint(path)
    assert payload["step"] == 3
    want = flax_to_torch(v)
    assert sorted(payload["state_dict"]) == sorted(want)
    assert any(".MaskedBatchNorm_" in k for k in want)
    for k in want:
        assert torch.equal(payload["state_dict"][k], want[k]), k
    det = build_detector(m, None, tc, device="cpu")
    det.module.load_state_dict(payload["state_dict"], strict=True)


def test_two_stage_over_sparse_first_stage_matches_jax():
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    rng = np.random.RandomState(22)
    m, tc = tiny_two_stage_cfg(TWO_STAGE, freeze=True)
    m["first_stage_cfg"] = with_sparse_backbone(m["first_stage_cfg"])
    fs = m["first_stage_cfg"]
    pts, mask = synthetic_points(rng, fs["bbox_head"]["voxel_generator"][
        "range"], 2000, 2400, c=fs["backbone"]["num_input_features"])
    ex = _voxel_inputs(pts, mask, fs, MAX_VOXELS, "features")
    jdet = jax_build(m, None, tc)
    v = randomize(jdet.init(jax.random.PRNGKey(0), ex), rng)
    jout = {k: np.asarray(x) for k, x in jax.jit(jdet.predict)(v, ex).items()}
    tdet = build_detector(m, None, tc, device="cpu")
    assert tdet.input_kind == "voxels"
    load_converted(tdet.module, v)
    tout = {k: x.numpy() for k, x in tdet.predict(
        {k: torch.from_numpy(a) for k, a in ex.items()}).items()}
    keep = jout["mask"]
    assert tout["mask"].sum() > 10
    np.testing.assert_array_equal(tout["mask"], keep)
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    np.testing.assert_allclose(tout["box3d_lidar"][keep],
                               jout["box3d_lidar"][keep], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=0,
                               atol=1e-4)


def test_input_kinds_and_refusals(tmp_path):
    """``input_kind`` follows the backbone; a points-only example, a train
    step and a ``tools.train`` run of a sparse config each stop with a
    message; other backbones still raise naming their ROADMAP item."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.tools import train as train_cli
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    dense, tc = tiny_frame_cfg()
    assert build_detector(dense, None, tc, device="meta").input_kind == \
        "points"
    m, tc = _cfg("centerpoint")
    det = build_detector(m, None, tc, device="cpu")
    assert det.input_kind == "voxels"
    assert det.module.backbone.out_features == SPARSE_BEV
    pts, mask = synthetic_points(np.random.RandomState(0), m["bbox_head"][
        "voxel_generator"]["range"], 100, 128)
    with pytest.raises(ValueError, match="takes voxel inputs"):
        det.predict({"points": torch.from_numpy(pts),
                     "points_mask": torch.from_numpy(mask)})
    with pytest.raises(NotImplementedError,
                       match="training through voxel inputs"):
        make_train_step(det, build_one_cycle_optimizer(det.module, 1e-3, 4))
    for bb in ("PointPillarsScatter", "DynamicPPScatter"):
        with pytest.raises(NotImplementedError, match="pillar.py"):
            build_detector(dict(m, backbone=dict(type=bb)), None, tc,
                           device="meta")
    info = make_waymo_infos(tmp_path, n=2, seed=3)
    cfg_path = write_tiny_eval_config(str(tmp_path / "cfg.py"), info,
                                      str(tmp_path))
    _sparse_config_file(cfg_path)
    with pytest.raises(SystemExit, match="training through voxel inputs"):
        train_cli.main([cfg_path, "--work_dir", str(tmp_path / "wd"),
                        "--device", "cpu"])
    assert not os.path.exists(tmp_path / "wd" / "latest")


def _sparse_config_file(path):
    with open(path, "a") as f:
        f.write(f"""
model["backbone"] = dict(type="SpMiddleResNetFHD", num_input_features=7)
model["neck"]["num_input_features"] = {SPARSE_BEV}
voxel_generator["max_voxel_num"] = [{MAX_VOXELS}, {MAX_VOXELS}]
""")


def test_dist_test_voxels_from_modelzoo_bit_equal_to_predict(tmp_path,
                                                             monkeypatch):
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.utils.config import load_config

    info = make_waymo_infos(tmp_path, n=3, seed=4)
    cfg_path = write_tiny_eval_config(str(tmp_path / "cfg.py"), info,
                                      str(tmp_path))
    _sparse_config_file(cfg_path)
    cfg = load_config(cfg_path)
    det = build_detector(cfg["model"], None, cfg["test_cfg"], device="cpu",
                         generator=torch.Generator().manual_seed(5))
    ckpt = save_checkpoint(str(tmp_path / "wd"), 1, det.module.state_dict())
    zoo = tmp_path / "zoo.json"
    zoo.write_text(json.dumps({"sparse_partner": ckpt}))
    monkeypatch.setenv("PARTNER_TPU_MODEL_ZOO", str(zoo))
    monkeypatch.setenv("PARTNER_TPU_CACHE", str(tmp_path / "cache"))
    (metrics, _), fps = dist_test.main([
        cfg_path, "--device", "cpu", "--input", "voxels", "--max_points",
        "5000", "--checkpoint", "modelzoo://sparse_partner", "--work_dir",
        str(tmp_path / "eval")])
    assert fps > 0 and metrics
    with open(tmp_path / "eval" / "prediction.pkl", "rb") as f:
        got = pickle.load(f)
    vox = DeviceVoxelizer(cfg["voxel_generator"], "cpu", MAX_VOXELS)
    ds = tdata.build_dataset(dict(cfg["data"]["val"]))
    n = 0
    for b in DataLoader(ds, 1, shuffle=False, max_points=5000):
        ex = {k: torch.from_numpy(b[k]) for k in ("points", "points_mask")}
        ex.update(vox(ex["points"], ex["points_mask"]))
        o = det.predict(ex)
        m = o["mask"][0]
        g = got[b["metadata"][0]["token"]]
        assert len(g["scores"]) == int(m.sum()) > 5
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(g[k], o[k][0][m].numpy(), err_msg=k)
        n += 1
    assert n == len(got) == 3
