"""The Waymo PointPillars two-stage detectors in partner_tpu_torch against
the JAX package (CPU, float32).

Both configs (``configs/waymo/pp/two_stage/waymo_centerpoint_pp{,_two_
cls}_two_pfn_stride1_two_stage_bev_6epoch.py``: ``TwoStageDetector``
around the frozen one-stage ``PointPillars``, 5 bilinear samples a
proposal on the stride-1 neck map, the RoI head over 5 x the neck width
+ 1 inputs) with the first stage cut as ``tests/test_torch_pp.py`` cuts
it (``torch_port_fixtures.tiny_pp_two_stage_cfg``): the four-corner
gather at stride 1 on the full 468 x 468 cuboid grid, ``predict`` of one
shared JAX detector per config, the frozen step against JAX's frozen
loss, the CLIs from a port one-stage checkpoint through ``pretrained``,
and both configs at full width on the meta device.
"""

import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_centerpoint import finish, port
from test_torch_two_stage_train import _plant_positives
from torch_port_fixtures import (PP_TWO_STAGE, PP_TWO_STAGE_CONFIGS,
                                 drawn_init, load_converted, pp_points,
                                 randomize, tiny_pp_two_stage_cfg,
                                 write_three_class_infos,
                                 write_tiny_pp_two_stage_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS, N_ROWS = 4000, 4800
MAX_POINTS = 6000     # the CLIs' point buffer


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_bev_bilinear_sample_at_stride_one_matches_jax(rng):
    """The four-corner gather on the configs' own 468 x 468 cuboid grid
    (0.32 m cells, the neck map at stride 1), points inside, at cell
    centres and off every edge, against ``map_coordinates(order=1,
    mode="constant")``: within 1e-6 relative or 5e-6 absolute (measured
    1.2e-7; with the coordinate rounded twice, as a multiply and an add
    apart, 2.1e-5: XLA fuses them into one rounding); a cell centre gives
    its cell's value within the coordinate's own float32 rounding, 468 x
    2^-24 of a cell on values 2 apart (1e-4)."""
    from partner_tpu.models.two_stage import bev_bilinear_sample as jfn
    from partner_tpu_torch.models.two_stage import bev_bilinear_sample
    from partner_tpu_torch.utils.config import load_config

    vg = load_config(os.path.join(ROOT, PP_TWO_STAGE))["voxel_generator"]
    pr = tuple(vg["range"])
    n = int(round((pr[3] - pr[0]) / vg["voxel_size"][0]))
    assert n == 468
    bev = rng.uniform(-1, 1, (n, n, 4)).astype(np.float32)
    ci, cj = rng.randint(0, n, 30), rng.randint(0, n, 30)
    centres = np.stack([pr[0] + (ci + 0.5) * vg["voxel_size"][0],
                        pr[1] + (cj + 0.5) * vg["voxel_size"][1]], 1)
    pts = np.concatenate([rng.uniform(-80, 80, (600, 2)), centres])
    pts = pts.astype(np.float32)
    want = np.asarray(jax.jit(lambda b, p: jfn(
        b, p, pr, 1, None, voxel_shape="cuboid"))(bev, pts))
    got = bev_bilinear_sample(t(bev[None]), t(pts[None]), pr, "cuboid")[0]
    got = got.numpy()
    assert (np.abs(want).sum(1) == 0).sum() > 5        # wholly off the map
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=5e-6)
    np.testing.assert_allclose(got[-30:], bev[cj, ci], rtol=0, atol=1e-4)


@pytest.fixture(scope="module", params=list(PP_TWO_STAGE_CONFIGS))
def pair(request):
    """One config in both packages from one drawn tree (both stages), and a
    batch of two cuboid sweeps (the second with twinned points)."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.models.two_stage import TwoStageModule
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_pp_two_stage_cfg(PP_TWO_STAGE_CONFIGS[request.param])
    rng = np.random.RandomState(3)
    pr = m["first_stage_cfg"]["bbox_head"]["voxel_generator"]["range"]
    a, ma = pp_points(rng, pr, N_POINTS, N_ROWS)
    b, mb = pp_points(rng, pr, N_POINTS - 500, N_ROWS, dup=800)
    ex = {"points": np.concatenate([a, b]),
          "points_mask": np.concatenate([ma, mb])}
    jdet = jax_build(m, None, tc)
    v = randomize(drawn_init(functools.partial(
        jdet.module.init, method=TwoStageModule.init_all), rng, ex), rng)
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    return dict(name=request.param, m=m, tc=tc, jdet=jdet, v=v, tdet=tdet,
                ex=ex)


def test_predict_matches_jax(pair):
    """``predict`` of both packages at batch 2: the neck map the RoI head
    samples within 1e-5; the kept indices (mask and labels of the 3 or 2
    classes) exact; the refined boxes within 1e-4 and the geometric-mean
    scores within 1e-5, as the VoxelNet two-stage test holds them."""
    jdet, v, ex = pair["jdet"], pair["v"], pair["ex"]
    tex = {k: t(a) for k, a in ex.items()}
    _, jbev = jax.jit(lambda v, e: jdet.module.apply(v, e, train=False))(
        v, ex)
    jout = {k: np.asarray(a) for k, a in jax.jit(jdet.predict)(v, ex).items()}
    with torch.no_grad():
        _, bev = pair["tdet"].module(tex)
    tout = {k: a.numpy() for k, a in pair["tdet"].predict(tex).items()}
    assert bev.shape == (2, 64, 64, 48)
    np.testing.assert_allclose(bev.numpy(), np.asarray(jbev), rtol=1e-5,
                               atol=1e-5)
    assert tout["mask"].shape == jout["mask"].shape == (2, 64)
    assert tout["box3d_lidar"].shape[-1] == 7
    assert tout["mask"].sum() > 40
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    n_cls = 3 if pair["name"] == "three-class" else 2
    assert set(np.unique(tout["label_preds"])) <= set(range(n_cls))
    m = jout["mask"]
    np.testing.assert_allclose(tout["box3d_lidar"][m], jout["box3d_lidar"][m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=0,
                               atol=1e-5)
    assert np.all(tout["scores"][~m] == 0)


def test_frozen_step_matches_jax_loss(pair):
    """The frozen step (both configs set ``freeze``): the port's pillar
    first stage runs in eval mode without autograd, its ``MaskedBatchNorm``
    on running statistics; JAX's ``loss(..., train=False)`` runs it on the
    same statistics under ``stop_gradient``. The RoI losses within 1e-5
    and the RoI head's gradients within 1e-3 of JAX's; the optimizer
    holds the RoI head's 12 tensors alone; after the step the first
    stage's parameters and statistics (the PFN's among them) are
    bit-unchanged and every RoI parameter moved."""
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    jdet, v, m, tc = pair["jdet"], pair["v"], pair["m"], pair["tc"]
    tdet = build_detector(m, None, tc, device="cpu")
    load_converted(tdet.module, v)
    assert tdet.freeze and tdet.loss_keys == (
        "points", "points_mask", "global_box", "global_box_mask")
    ex = dict(pair["ex"], global_box=np.zeros((2, 12, 10), np.float32),
              global_box_mask=np.zeros((2, 12), bool))
    ex = _plant_positives(jdet, v, ex, train=False)
    jex = jax.tree_util.tree_map(jnp.asarray, ex)

    def loss_fn(params):
        ld, _ = jdet.loss({"params": params,
                           "batch_stats": v["batch_stats"]}, jex,
                          train=False)
        return ld["loss"], ld

    (_, jld), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    jg = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                         jgrads)})
    before = {k: x.clone() for k, x in tdet.module.state_dict().items()}
    assert any(k.startswith("first.reader.pfn0_bn.") for k in before)
    opt = build_one_cycle_optimizer(tdet.module, 3e-3, 1000)
    roi = [n for n, _ in tdet.module.named_parameters()
           if n.startswith("roi_head.")]
    assert len(opt.params) == len(roi) == 12
    met = make_train_step(tdet, opt)(
        {k: t(a) for k, a in ex.items()}, torch.Generator().manual_seed(0))
    assert sorted(met) == ["grad_norm", "loss", "roi_cls_loss",
                           "roi_reg_loss"]
    assert not tdet.module.first.training
    assert not tdet.module.first.reader.pfn0_bn.training
    assert float(met["roi_reg_loss"]) > 0      # the planted positives
    for k in ("roi_cls_loss", "roi_reg_loss", "loss"):
        np.testing.assert_allclose(float(met[k]), float(jld[k]), rtol=1e-5,
                                   err_msg=k)
    gmax = max(float(np.abs(jg[n].numpy()).max()) for n in roi)
    for n, p in tdet.module.named_parameters():
        if n.startswith("first."):
            assert p.grad is None and not p.requires_grad, n
            assert not np.any(jg[n].numpy()), n
            continue
        np.testing.assert_allclose(p.grad.numpy(), jg[n].numpy(), rtol=1e-3,
                                   atol=1e-5 * gmax, err_msg=n)
    after = tdet.module.state_dict()
    for k, x in before.items():
        if k.startswith("first."):
            assert torch.equal(after[k], x), k
        else:
            assert not torch.equal(after[k], x), k


# ------------------------------------------------------------ entry points

_PORT_CLIS = r"""
import json, os, sys
from partner_tpu_torch.tools import dist_test, train
cfg, work = sys.argv[1:3]
common = ["--device", "cpu", "--max_points", sys.argv[3]]
steps = train.main([cfg, "--work_dir", os.path.join(work, "train"),
                    "--batch_size", "2", "--total_steps", "2",
                    "--max_steps_per_epoch", "2"] + common)
(metrics, _), fps = dist_test.main([
    cfg, "--checkpoint", os.path.join(work, "train", "latest"),
    "--work_dir", os.path.join(work, "eval")] + common)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "steps": steps, "metrics": metrics}))
"""


def test_clis_from_a_pretrained_first_stage(tmp_path):
    """The 3-class config's ``train`` (two frozen steps at batch 2, no
    ``--load_from``: the first stage from a seeded port one-stage
    PointPillars checkpoint that ``pretrained`` names) then ``dist_test``
    from its checkpoint, ``--device cpu``, in one fresh process that
    imports nothing of JAX: finite RoI losses and Waymo metrics; the
    checkpoint's first stage bit-equal to the pretrained one, the Adam
    moments the RoI head's alone; every frame's kept boxes bit-equal to a
    direct ``predict`` of the same collated frame."""
    from partner_tpu_torch.data import build_dataset
    from partner_tpu_torch.data.loader import DataLoader
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from partner_tpu_torch.utils.config import load_config

    m, tc = tiny_pp_two_stage_cfg()
    gen = torch.Generator().manual_seed(7)
    one = build_detector(m["first_stage_cfg"], None, tc, device="cpu",
                         generator=gen)
    for name, p in one.module.named_parameters():
        if name.endswith(("_bn.scale", "_bn.bias")):
            with torch.no_grad():
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
    pretrained = str(tmp_path / "one_stage" / "latest")
    save_checkpoint(str(tmp_path / "one_stage"), 0, one.module.state_dict())
    info = write_three_class_infos(str(tmp_path / "infos.pkl"),
                                   np.random.RandomState(12), upper=True)
    cfg_path = write_tiny_pp_two_stage_config(
        str(tmp_path / "cfg.py"), info, info, str(tmp_path),
        pretrained=pretrained)
    res = finish(port(["-c", _PORT_CLIS, cfg_path, str(tmp_path),
                       str(MAX_POINTS)]))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["steps"] == 2
    assert np.isfinite(got["metrics"]["mAP/L1"])
    with open(tmp_path / "train" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite([r[k] for k in ("loss", "roi_cls_loss",
                                           "roi_reg_loss", "grad_norm")]).all()
               for r in recs)
    payload = load_checkpoint(str(tmp_path / "train" / "latest"))[0]
    sd = payload["state_dict"]
    for k, x in one.module.state_dict().items():
        assert torch.equal(sd["first." + k], x), k
    assert sorted(payload["opt_state"]["mu"]) == sorted(
        k for k in sd if k.startswith("roi_head."))

    cfg = load_config(cfg_path)
    det = build_detector(cfg["model"], None, cfg["test_cfg"], device="cpu")
    det.module.load_state_dict(sd)
    with open(tmp_path / "eval" / "prediction.pkl", "rb") as f:
        preds = pickle.load(f)
    n = 0
    for b in DataLoader(build_dataset(dict(cfg["data"]["val"])), 1,
                        shuffle=False, max_points=MAX_POINTS):
        o = det.predict({k: t(b[k]) for k in ("points", "points_mask")})
        keep = o["mask"][0]
        p = preds[b["metadata"][0]["token"]]
        assert len(p["scores"]) > 10
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(p[k], o[k][0][keep].numpy(),
                                          err_msg=k)
        n += 1
    assert n == len(preds) == 4


# ------------------------------------------------------- full width

@pytest.mark.parametrize("name", list(PP_TWO_STAGE_CONFIGS))
def test_full_width_builds_with_jax_parameter_count(name):
    """Each config at full width on the meta device: a frozen
    ``PointPillarsModule`` first stage (468 x 468 x 1 cuboid pillars,
    stride 1, the one-stage config's 3 or 2 classes) loaded from the
    ``pretrained`` it names, the RoI head 5 x 384 + 1 = 1921 -> 256 -> 256
    -> 1 and 7 (the config's ``input_channels`` of 1920 is read by
    neither package), train mode leaving the first stage (its
    ``MaskedBatchNorm``s too) in eval mode; every leaf's shape equal to
    ``jax.eval_shape`` of the JAX detector's ``init_all``."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.models.two_stage import TwoStageModule
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, PP_TWO_STAGE_CONFIGS[name]))
    det = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"],
                         device="meta")
    mod = det.module
    assert type(mod.first).__name__ == "PointPillarsModule"
    assert det.freeze and det.input_kind == "points"
    assert det.first_driver.voxel_shape == mod.voxel_shape == "cuboid"
    assert mod.first.grid_size == (468, 468, 1)
    assert mod.first.out_size_factor == 1
    assert det.pretrained == cfg["model"]["first_stage_cfg"]["pretrained"]
    assert det.pretrained.startswith("work_dirs/waymo_centerpoint_pp")
    assert cfg["model"]["roi_head"]["input_channels"] == 1920
    assert tuple(mod.roi_head.Dense_0.weight.shape) == (256, 1921)
    assert tuple(mod.roi_head.reg_out.weight.shape) == (7, 256)
    n_cls = 3 if name == "three-class" else 2
    assert mod.first.bbox_head.task0.hm_out.weight.shape[0] == n_cls
    assert not any(p.requires_grad for p in mod.first.parameters())
    mod.train()
    assert not mod.first.training and not mod.first.reader.pfn1_bn.training
    assert mod.roi_head.training
    ex = {"points": np.zeros((1, 64, 7), np.float32),
          "points_mask": np.zeros((1, 64), bool)}
    jdet = jax_build(cfg["model"], cfg["train_cfg"], cfg["test_cfg"])
    shapes = jax.eval_shape(lambda: jdet.module.init(
        jax.random.PRNGKey(0), ex, method=TwoStageModule.init_all))
    want = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
    sd = mod.state_dict()
    assert sorted(want) == sorted(sd)
    for k, x in sd.items():
        assert tuple(want[k].shape) == tuple(x.shape), k
