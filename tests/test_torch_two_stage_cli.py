"""The two-stage CenterPoint's entry points in partner_tpu_torch (CPU).

On the tiny cut of ``tests/test_torch_two_stage.py``: the train CLI with
``freeze=False`` against the JAX CLI from one JAX checkpoint (the port's
in a fresh process, which must import nothing of jax, flax, optax or
``partner_tpu``); the frozen fine-tune from a ``pretrained`` one-stage
checkpoint, its resume, and a missing ``pretrained``; ``dist_test``
against a direct ``predict``; and the serving tools on both configs.
"""

import json
import os
import pickle
import shutil
import tempfile

import numpy as np
import pytest
import torch

from test_torch_two_stage import _jax_init
from torch_port_fixtures import TWO_STAGE_VELO, tiny_two_stage_cfg

torch.set_num_threads(2)


MAX_POINTS = 5000


def _save_jax(path, params, batch_stats):
    from partner_tpu.train.checkpoint import save_checkpoint

    class State:   # what save_checkpoint reads of a TrainState
        step, opt_state = 0, {}

    State.params, State.batch_stats = params, batch_stats
    save_checkpoint(path, State)
    return os.path.join(path, "latest")


def _run_jax_train(argv):
    """``tools/train.py`` in this process with two faults of the JAX side
    worked around (ROADMAP.md §3): its log flush cannot take the per-task
    loss lists (``test_torch_centerpoint.run_jax`` sums them), and its
    ``TwoStageDetector`` keeps the ``Detector`` default ``input_kind``
    "voxels", so its CLI would voxelize for a first stage on the point
    path; it runs on the points here, as the port does."""
    from partner_tpu.models.two_stage import TwoStageDetector
    from test_torch_centerpoint import run_jax

    TwoStageDetector.input_kind = "points"
    try:
        return run_jax("train", argv)
    finally:
        del TwoStageDetector.input_kind


def _port(args):
    from test_torch_centerpoint import port

    return port(args)


_PORT_TRAIN = r"""
import json, sys
from partner_tpu_torch.tools import train
steps = train.main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "steps": steps}))
"""


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Six synthetic 3-class frames; one randomized tiny two-stage tree
    saved as a JAX checkpoint (both stages) and its first stage as a JAX
    one-stage checkpoint; two train-CLI steps of each package from the
    former (``--load_from``, ``freeze=False``), the port's in a fresh
    process."""
    from partner_tpu.models import build_detector as jax_build
    from test_torch_centerpoint import finish
    from torch_port_fixtures import (write_three_class_infos,
                                     write_tiny_two_stage_config)

    tmp = tmp_path_factory.mktemp("two_stage_cli")
    rng = np.random.RandomState(21)
    info = write_three_class_infos(str(tmp / "infos.pkl"), rng, n=6)
    m, tc = tiny_two_stage_cfg(freeze=False)
    v = _jax_init(jax_build(m, None, tc), 7, rng)
    ckpt = _save_jax(str(tmp / "two_stage"), v["params"], v["batch_stats"])
    one_stage = _save_jax(str(tmp / "one_stage"), v["params"]["first"],
                          v["batch_stats"]["first"])
    free = write_tiny_two_stage_config(str(tmp / "free.py"), info, info,
                                       str(tmp), freeze=False)
    common = ["--batch_size", "2", "--total_steps", "2",
              "--max_steps_per_epoch", "2", "--load_from", ckpt,
              "--max_points", str(MAX_POINTS)]
    proc = _port(["-c", _PORT_TRAIN, free, "--device", "cpu", "--work_dir",
                  str(tmp / "port_train")] + common)
    _run_jax_train([free, "--work_dir", str(tmp / "jax_train"), "--mesh",
                    "data=1"] + common)
    return dict(tmp=tmp, info=info, ckpt=ckpt, one_stage=one_stage,
                free=free, train=finish(proc))


def _records(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_matches_jax_cli(cli):
    """Two steps of each CLI from one JAX two-stage checkpoint with
    ``freeze=False``: step 0 as the CenterPoint CLI test holds it (1e-4 on
    every loss term, the RoI terms included, 2e-3 on the gradient norm);
    step 1 after one Adam update at random weights, whose chaotic upstream
    gradients move the runs apart, within 1% and 25%."""
    res = cli["train"]
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["steps"] == 2
    jm, pm = _records(cli["tmp"] / "jax_train"), _records(
        cli["tmp"] / "port_train")
    assert [r["step"] for r in pm] == [r["step"] for r in jm] == [0, 1]
    for j, p, (tol, norm_tol) in zip(jm, pm, ((1e-4, 2e-3), (0.01, 0.25))):
        assert p["lr"] == pytest.approx(j["lr"], rel=1e-6)
        for k in ("det_loss", "hm_loss", "loc_loss"):
            assert len(p[k]) == 1 and np.isfinite(p[k][0]), (k, p[k])
            assert abs(p[k][0] - j[k]) <= tol * abs(j[k]), (j["step"], k)
        for k in ("roi_cls_loss", "roi_reg_loss", "loss"):
            assert abs(p[k] - j[k]) <= tol * abs(j[k]) + 1e-7, (j["step"], k)
        assert abs(p["grad_norm"] - j["grad_norm"]) <= norm_tol * j[
            "grad_norm"]


def test_frozen_fine_tune_from_pretrained(cli, tmp_path):
    """The train CLI on a frozen config with ``pretrained`` at the JAX
    one-stage checkpoint, no ``--load_from``: after 3 steps the first
    stage's parameters and BatchNorm statistics are bit-equal to the
    checkpoint's, the RoI head's parameters moved from their seeded init
    (all that the loss or the weight decay reach), and the checkpoint
    holds the Adam moments of the RoI head alone. A resume
    from there to step 6 ends bit-equal to an unbroken 6-step run."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.tools import train
    from partner_tpu_torch.train.checkpoint import load_checkpoint
    from partner_tpu_torch.utils.config import load_config
    from torch_port_fixtures import write_tiny_two_stage_config

    cfg = write_tiny_two_stage_config(
        str(tmp_path / "frozen.py"), cli["info"], cli["info"],
        str(cli["tmp"]), freeze=True, pretrained=cli["one_stage"])
    common = [cfg, "--device", "cpu", "--batch_size", "2",
              "--max_steps_per_epoch", "3", "--max_points", str(MAX_POINTS)]
    whole, resumed = str(tmp_path / "whole"), str(tmp_path / "resumed")
    assert train.main(common + ["--work_dir", whole, "--total_steps",
                                "6"]) == 6
    payload = load_checkpoint(os.path.join(whole, "ckpt_00000003"))[0]
    sd = payload["state_dict"]
    pre = load_checkpoint(cli["one_stage"])[0]["state_dict"]
    assert len(pre) == sum(k.startswith("first.") for k in sd)
    for k, x in pre.items():
        assert torch.equal(sd["first." + k], x), k
    c = load_config(cfg)
    init = build_detector(c["model"], c["train_cfg"], c["test_cfg"],
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
    roi = {k: x for k, x in init.module.state_dict().items()
           if k.startswith("roi_head.")}
    assert len(roi) == 12
    still = [k for k, x in roi.items() if torch.equal(sd[k], x)]
    recs = _records(whole)
    assert {"loss", "roi_cls_loss", "roi_reg_loss"} <= set(recs[0])
    assert "det_loss" not in recs[0]
    # random first-stage proposals overlap no gt, so no positive: the
    # regression's bias (0 at init) gets no gradient and no decay
    assert all(r["roi_reg_loss"] == 0 for r in recs)
    assert still == ["roi_head.reg_out.bias"]
    assert not torch.any(sd["roi_head.reg_out.bias"])
    st = payload["opt_state"]
    assert st["count"] == 3 and sorted(st["mu"]) == sorted(st["nu"]) == \
        sorted(roi)

    # resume from the step-3 checkpoint alone
    shutil.copytree(os.path.join(whole, "ckpt_00000003"),
                    os.path.join(resumed, "ckpt_00000003"))
    with open(os.path.join(resumed, "latest"), "w") as f:
        f.write("ckpt_00000003")
    assert train.main(common + ["--work_dir", resumed, "--total_steps",
                                "6"]) == 6
    a = load_checkpoint(os.path.join(resumed, "latest"))[0]
    b = load_checkpoint(os.path.join(whole, "latest"))[0]
    assert a["step"] == b["step"] == 6
    for k in b["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    for key in ("mu", "nu"):
        assert sorted(a["opt_state"][key]) == sorted(roi)
        for k in roi:
            assert torch.equal(a["opt_state"][key][k],
                               b["opt_state"][key][k]), (key, k)
    for k, x in pre.items():
        assert torch.equal(a["state_dict"]["first." + k], x), k
    assert [r["loss"] for r in _records(resumed)] == [
        r["loss"] for r in recs[3:]]


def test_missing_pretrained_exits(cli, tmp_path):
    from partner_tpu_torch.tools import train
    from torch_port_fixtures import write_tiny_two_stage_config

    missing = str(tmp_path / "no_such_run" / "latest")
    cfg = write_tiny_two_stage_config(
        str(tmp_path / "frozen.py"), cli["info"], cli["info"],
        str(cli["tmp"]), freeze=True, pretrained=missing)
    with pytest.raises(SystemExit) as e:
        train.main([cfg, "--device", "cpu", "--work_dir",
                    str(tmp_path / "w"), "--total_steps", "1"])
    assert missing in str(e.value)
    assert "train the one-stage config first, or pass --load_from" in str(
        e.value)
    assert not os.path.exists(tmp_path / "w" / "latest")


def test_dist_test_matches_direct_predict(cli, tmp_path):
    """``dist_test --device cpu`` from the two-stage checkpoint: each
    frame's kept boxes, scores and labels bit-equal to the detector's own
    ``predict`` of the collated batch; finite 3-class metrics."""
    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.tools import dist_test
    from partner_tpu_torch.train.checkpoint import load_checkpoint
    from partner_tpu_torch.utils.config import load_config

    (metrics, _), fps = dist_test.main([
        cli["free"], "--device", "cpu", "--checkpoint", cli["ckpt"],
        "--work_dir", str(tmp_path), "--max_points", str(MAX_POINTS)])
    assert fps > 0
    for k in ("AP/L1/Vehicle", "AP/L1/Pedestrian", "AP/L1/Cyclist"):
        assert np.isfinite(metrics[k]), k
    with open(tmp_path / "prediction.pkl", "rb") as f:
        pred = pickle.load(f)
    cfg = load_config(cli["free"])
    det = build_detector(cfg["model"], None, cfg["test_cfg"], device="cpu")
    det.module.load_state_dict(load_checkpoint(cli["ckpt"])[0][
        "state_dict"])
    ds = tdata.build_dataset(dict(cfg["data"]["val"]))
    seen = 0
    for b in DataLoader(ds, 1, shuffle=False, max_points=MAX_POINTS):
        o = det.predict({k: torch.from_numpy(b[k])
                         for k in ("points", "points_mask")})
        m = o["mask"][0]
        got = pred[b["metadata"][0]["token"]]
        assert int(m.sum()) > 10
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(got[k], o[k][0][m].numpy(),
                                          err_msg=k)
        seen += 1
    assert seen == len(pred) == 6


def _port_checkpoint(path, cfg_path):
    """Seeded port weights of a config saved as a port checkpoint."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import save_checkpoint
    from partner_tpu_torch.utils.config import load_config

    c = load_config(cfg_path)
    det = build_detector(c["model"], None, c["test_cfg"], device="cpu",
                         generator=torch.Generator().manual_seed(7))
    save_checkpoint(path, 0, det.module.state_dict())
    return os.path.join(path, "latest")


# the tiny cut holds a few thousand points: a smaller voxel capacity keeps
# the serving tools' stem and scatter at a CPU size
CAPACITY = "voxel_generator['max_voxel_num'] = [3000, 4000]\n"


def test_multi_sweep_inference_serves_the_two_sweep_config(cli, tmp_path):
    """``multi_sweep_inference --nsweeps 2`` with the two-sweep velocity
    two-stage config (the voxel path, 8 features): every frame's boxes
    keep their velocity columns, and the last frame equals the detector's
    direct ``predict`` of its two sweeps' buffer."""
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.tools import multi_sweep_inference as tmsi
    from partner_tpu_torch.tools.single_inference import build_predictor
    from partner_tpu_torch.utils.config import load_config
    from torch_port_fixtures import write_tiny_two_stage_config

    with open(cli["info"], "rb") as f:
        infos = pickle.load(f)[:3]
    for i, info in enumerate(infos):
        pose = np.eye(4)
        pose[:3, 3] = [1.5 * i, 0.2 * i, 0.0]
        info.update(pose=pose, timestamp=1.0e6 + 0.1 * i)
    info_path = str(tmp_path / "sweeps.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    cfg_path = write_tiny_two_stage_config(
        str(tmp_path / "velo.py"), info_path, info_path, str(tmp_path),
        config=TWO_STAGE_VELO)
    with open(cfg_path, "a") as f:
        f.write(CAPACITY)
    ckpt = _port_checkpoint(str(tmp_path / "ckpt"), cfg_path)
    dets, fps = tmsi.main([cfg_path, "--info_path", info_path,
                           "--checkpoint", ckpt, "--nsweeps", "2",
                           "--max_points", str(2 * MAX_POINTS),
                           "--work_dir", str(tmp_path / "out"),
                           "--device", "cpu"])
    assert fps > 0 and len(dets) == 3
    assert all(d["box3d_lidar"].shape[1] == 9 and len(d["scores"]) > 10
               for d in dets.values())
    kept = [(i["points"], i["pose"], i["timestamp"]) for i in infos[-2:]]
    feats = tmsi.frame_points(kept, infos[-1]["pose"],
                              infos[-1]["timestamp"], "cylinder", 8)
    cfg = load_config(cfg_path)
    det, _, _ = build_predictor(cfg, ckpt, 2 * MAX_POINTS, device="cpu")
    buf = np.zeros((1, 2 * MAX_POINTS, 8), np.float32)
    buf[0, :len(feats)] = feats
    mask = np.zeros((1, 2 * MAX_POINTS), bool)
    mask[0, :len(feats)] = True
    vox = DeviceVoxelizer(cfg["voxel_generator"], "cpu", 3000)
    out = det.predict(vox(torch.from_numpy(buf), torch.from_numpy(mask)))
    m = out["mask"][0].numpy()
    for k in ("box3d_lidar", "scores", "label_preds"):
        np.testing.assert_array_equal(dets[infos[-1]["token"]][k],
                                      out[k][0].numpy()[m], err_msg=k)


def test_single_inference_serves_the_one_sweep_config(cli, tmp_path):
    """``single_inference`` with the one-sweep two-stage config: a frame's
    kept boxes equal the detector's direct ``predict`` of its voxels."""
    from partner_tpu_torch.core import box_np_ops
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer
    from partner_tpu_torch.tools import single_inference as tsi
    from partner_tpu_torch.utils.config import load_config
    from torch_port_fixtures import write_tiny_two_stage_config

    cfg_path = write_tiny_two_stage_config(
        str(tmp_path / "one.py"), cli["info"], cli["info"], str(tmp_path))
    with open(cfg_path, "a") as f:
        f.write(CAPACITY)
    ckpt = _port_checkpoint(str(tmp_path / "ckpt"), cfg_path)
    with open(cli["info"], "rb") as f:
        pts = pickle.load(f)[0]["points"]
    cfg = load_config(cfg_path)
    det, predict, meta = tsi.build_predictor(cfg, ckpt, MAX_POINTS,
                                             device="cpu")
    got = tsi.run_frame(predict, meta, pts, score_threshold=0.0)
    assert len(got["scores"]) > 10
    feats = box_np_ops.transform_points(pts, "cylinder")[:, :7]
    buf = np.zeros((1, MAX_POINTS, 7), np.float32)
    buf[0, :len(feats)] = feats
    mask = np.zeros((1, MAX_POINTS), bool)
    mask[0, :len(feats)] = True
    vox = DeviceVoxelizer(cfg["voxel_generator"], "cpu", 3000)
    direct = det.predict(vox(torch.from_numpy(buf), torch.from_numpy(mask)))
    m = direct["mask"][0].numpy()
    for k in ("box3d_lidar", "scores", "label_preds"):
        np.testing.assert_array_equal(got[k], direct[k][0].numpy()[m],
                                      err_msg=k)



def test_resume_from_jax_frozen_checkpoint():
    """A JAX checkpoint of the frozen config holds Adam moments of every
    parameter; the port resumes from it with the RoI head's moments and
    the count, and leaves out the first stage's."""
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    restore_train_state)
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer

    rng = np.random.RandomState(31)
    m, tc = tiny_two_stage_cfg(freeze=True)
    v = _jax_init(jax_build(m, None, tc), 7, rng)
    # a count of 1 and random moments (a transposed Dense kernel shows)
    opt_state = jax.tree_util.tree_map(
        lambda a: a + (np.asarray(rng.rand(*a.shape), np.float32)
                       if np.issubdtype(a.dtype, np.floating) else 1),
        jax_opt(3e-3, 100).init(v["params"]))

    class State:   # what save_checkpoint reads of a TrainState
        step, params, batch_stats = 1, v["params"], v["batch_stats"]

    State.opt_state = opt_state
    det = build_detector(m, None, tc, device="cpu")
    opt = build_one_cycle_optimizer(det.module, 3e-3, 100)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, State)
        payload = load_checkpoint(os.path.join(d, "latest"))[0]
    assert len(payload["opt_state"]["mu"]) > len(opt.params) == 12
    assert restore_train_state(det, opt, payload) == 1
    assert opt.count == 1
    roi = [n for n, _ in det.module.named_parameters()
           if n.startswith("roi_head.")]
    adam = jax.tree_util.tree_map(np.asarray,
                                  opt_state.inner_state[1].mu)
    want = flax_to_torch({"params": adam})
    for n, mu in zip(roi, opt.state_dict()["mu"]):
        assert torch.equal(mu, want[n]) and torch.all(mu > 0), n
