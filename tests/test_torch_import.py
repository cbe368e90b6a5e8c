"""partner_tpu_torch stands alone: no jax, flax, optax or partner_tpu at
import or when it builds its detectors, and the flax converter covers every
parameter and buffer of the port's detectors."""

import os
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_out_jax_and_flax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import partner_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'partner_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 66, names\n"
        "for n in ('ops.swin_block', 'ops.scatter_max', 'core.targets',\n"
        "          'losses.centernet', 'losses.matcher', 'losses.set_crit',\n"
        "          'train.optim', 'train.train_state', 'data.pipeline',\n"
        "          'eval.evaluator', 'train.checkpoint', 'tools.dist_test',\n"
        "          'data.augment', 'data.gt_aug', 'data.loader',\n"
        "          'train.hooks', 'tools.train', 'models.center_head',\n"
        "          'native', 'ops.voxelize', 'models.readers',\n"
        "          'tools.single_inference', 'tools.multi_sweep_inference',\n"
        "          'data.waymo_decoder', 'models.two_stage',\n"
        "          'tools.create_data', 'models.sparse', 'models.backbone',\n"
        "          'train.torch_convert', 'tools.convert_checkpoint',\n"
        "          'utils.remote_io'):\n"
        "    assert 'partner_tpu_torch.' + n in names, n\n"
        "from partner_tpu_torch.models import build_detector\n"
        "from partner_tpu_torch.utils.config import load_config\n"
        "for c in ('waymo_partner_36epoch', 'waymo_centerpoint_voxelnet_36epoch',\n"
        "          'waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo',\n"
        "          'two_stage/waymo_centerpoint_voxelnet_two_stage_bev_5point_'\n"
        "          'ft_6epoch_freeze',\n"
        "          'two_stage/waymo_centerpoint_voxelnet_two_sweep_two_stage_'\n"
        "          'bev_5point_ft_6epoch_freeze_with_vel'):\n"
        "    cfg = load_config(f'configs/waymo/{c}.py')\n"
        "    build_detector(cfg['model'], cfg['train_cfg'], cfg['test_cfg'],\n"
        "                   device='meta')\n"
        "for c in ('waymo_partner_36epoch', 'waymo_centerpoint_voxelnet_36epoch'):\n"
        "    cfg = load_config(f'configs/waymo/{c}.py')\n"
        "    m = dict(cfg['model'], backbone=dict(type='SpMiddleResNetFHD',\n"
        "             num_input_features=cfg['model']['backbone'][\n"
        "                 'num_input_features']))\n"
        "    m['neck'] = dict(m['neck'], num_input_features=256)\n"
        "    det = build_detector(m, cfg['train_cfg'], cfg['test_cfg'],\n"
        "                         device='meta')\n"
        "    assert det.input_kind == 'voxels', c\n"
        "    assert det.module.backbone.out_features == 256, c\n"
        "from partner_tpu_torch import native\n"
        "assert native.available()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'partner_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_converter_covers_the_detector_exactly(rng):
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector

    from torch_port_fixtures import synthetic_points, tiny_frame_cfg

    model_cfg, test_cfg = tiny_frame_cfg()
    pts, mask = synthetic_points(
        rng, model_cfg["bbox_head"]["voxel_generator"]["range"], 50, 64)
    v = jax_build(model_cfg, None, test_cfg).init(
        jax.random.PRNGKey(0), {"points": pts, "points_mask": mask})
    sd = flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(v)))
    module = build_detector(model_cfg, None, test_cfg, device="cpu").module
    want = module.state_dict()
    # nothing missing, nothing unused, every shape equal
    assert sorted(sd) == sorted(want)
    for k, t in want.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
    module.load_state_dict(sd, strict=True)


def test_converter_covers_the_centerpoint_detector_exactly(rng):
    """The same for the CenterPoint VoxelNet: the 3D trunk's kernels
    (DHWIO) and CenterHead's flax names (``Conv_0``, ``task0/hm_conv0``,
    ``task0/hm_out``, ...) map by the walker's rules, none added for it but
    the 3D kernel layout."""
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.models import build_detector

    from torch_port_fixtures import (CENTERPOINT_VELO, synthetic_points,
                                     tiny_centerpoint_cfg)

    model_cfg, test_cfg = tiny_centerpoint_cfg(CENTERPOINT_VELO)
    pts, mask = synthetic_points(
        rng, model_cfg["bbox_head"]["voxel_generator"]["range"], 50, 64, c=8)
    v = jax_build(model_cfg, None, test_cfg).init(
        jax.random.PRNGKey(0), {"points": pts, "points_mask": mask})
    sd = flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(v)))
    module = build_detector(model_cfg, None, test_cfg, device="cpu").module
    want = module.state_dict()
    assert sorted(sd) == sorted(want)
    for k, t in want.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
    assert "bbox_head.task0.hm_out.bias" in sd
    assert tuple(sd["backbone.conv_a.Conv_0.weight"].shape) == (64, 64, 3, 3,
                                                                3)
    module.load_state_dict(sd, strict=True)


def test_config_reader_matches_jax_config():
    from partner_tpu.train.config import Config
    from partner_tpu_torch.utils.config import load_config

    path = os.path.join(ROOT, "configs/waymo/waymo_partner_36epoch.py")
    ours, ref = load_config(path), Config.fromfile(path)
    assert sorted(ours) == sorted(ref.keys())
    for k in ("model", "test_cfg", "voxel_generator", "grid_size"):
        assert ours[k] == ref[k], k
