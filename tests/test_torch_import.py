"""partner_tpu_torch stands alone: no jax, flax, optax or partner_tpu at
import, and the flax converter covers every parameter and buffer of the
port's detector."""

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
        "assert len(names) >= 52, names\n"
        "for n in ('ops.swin_block', 'ops.scatter_max', 'core.targets',\n"
        "          'losses.centernet', 'losses.matcher', 'losses.set_crit',\n"
        "          'train.optim', 'train.train_state', 'data.pipeline',\n"
        "          'eval.evaluator', 'train.checkpoint', 'tools.dist_test',\n"
        "          'data.augment', 'data.gt_aug', 'data.loader',\n"
        "          'train.hooks', 'tools.train'):\n"
        "    assert 'partner_tpu_torch.' + n in names, n\n"
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


def test_config_reader_matches_jax_config():
    from partner_tpu.train.config import Config
    from partner_tpu_torch.utils.config import load_config

    path = os.path.join(ROOT, "configs/waymo/waymo_partner_36epoch.py")
    ours, ref = load_config(path), Config.fromfile(path)
    assert sorted(ours) == sorted(ref.keys())
    for k in ("model", "test_cfg", "voxel_generator", "grid_size"):
        assert ours[k] == ref[k], k
