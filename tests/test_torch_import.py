"""partner_tpu_torch stands alone: no jax, flax, optax or partner_tpu at
import (every module, the host tools, the FLOP counter and CSWin too, the
box coders, the polygon BEV IoU and circle NMS) or when it builds its
detectors (the Waymo PARTNER under each of the seven box coders of
``CODER_CONFIG["type"]``, CenterPoint and
two-stage configs, the sparse backbone, the three nuScenes CenterPoint
configs, the two Waymo PointPillars configs, the two PointPillars
two-stage configs, the nuScenes single-head config, the two PolarStream
det configs, the five seg configs and the four HAN / STROBE configs: all
27 model configs under ``configs/`` but ``configs/tests/``), and the flax
converter covers every parameter and buffer of the port's detectors."""

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
        "assert len(names) >= 90, names\n"
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
        "          'utils.remote_io', 'ops.deform_conv',\n"
        "          'eval.nusc_protocol', 'eval.nuscenes', 'models.pillar',\n"
        "          'ops.nms', 'models.layers', 'convert',\n"
        "          'models.rpn_stream', 'models.polarstream',\n"
        "          'models.seg_head', 'eval.seg_metrics', 'models.strobe',\n"
        "          'ops.warp', 'parallel', 'parallel.dist',\n"
        "          'parallel.mesh', 'parallel.halo', 'parallel.tp',\n"
        "          'losses.iou_losses', 'eval.tracking',\n"
        "          'utils.viz3d', 'utils.flops', 'models.cswin',\n"
        "          'tools.track', 'tools.track_line_search',\n"
        "          'tools.nms_ensemble', 'tools.demo',\n"
        "          'tools.generate_instance_ids', 'tools.flops_report',\n"
        "          'core.center_coder', 'core.geometry', 'ops.rotated_iou'):\n"
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
        "from partner_tpu_torch.core.center_coder import CODERS\n"
        "from partner_tpu_torch.models.layers import ConvBNReLU\n"
        "from partner_tpu_torch.ops.nms import circle_nms\n"
        "from partner_tpu_torch.ops.rotated_iou import boxes_iou_bev\n"
        "from partner_tpu_torch.train.hooks import ClosureHook\n"
        "cfg = load_config('configs/waymo/waymo_partner_36epoch.py')\n"
        "extra = {'CenterCoderPolarTP': dict(template_ratio=2.2),\n"
        "         'CenterCoderTP': dict(templates_box=[4.5, 2.0, 1.6]),\n"
        "         'CenterCoderMTTP': dict(tmp_box=[[4.5, 2.0, 1.6]])}\n"
        "assert len(CODERS) == 7, CODERS\n"
        "for kind in CODERS:\n"
        "    bh = dict(cfg['model']['bbox_head'], CODER_CONFIG=dict(\n"
        "        cfg['model']['bbox_head']['CODER_CONFIG'], type=kind,\n"
        "        **extra.get(kind, {})))\n"
        "    det = build_detector(dict(cfg['model'], bbox_head=bh),\n"
        "                         cfg['train_cfg'], cfg['test_cfg'],\n"
        "                         device='meta')\n"
        "    assert type(det.coder).__name__ == kind, kind\n"
        "    assert det.criterion.coder is det.coder, kind\n"
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
        "for c in ('01voxel', 'dcn', 'dcn_flip'):\n"
        "    cfg = load_config(f'configs/nusc/voxelnet/'\n"
        "                      f'nusc_centerpoint_voxelnet_{c}.py')\n"
        "    det = build_detector(cfg['model'], cfg['train_cfg'],\n"
        "                         cfg['test_cfg'], device='meta')\n"
        "    assert det.module.bbox_head.num_tasks == 6, c\n"
        "    assert bool(det.test_cfg.get('double_flip')) == (c == 'dcn_flip')\n"
        "    w = det.module.backbone.stem0_kernel.shape[0]\n"
        "    assert w == (8 if c == 'dcn_flip' else 10), (c, w)\n"
        "    assert hasattr(det.module.bbox_head.task5, 'feature_adapt_cls') \\\n"
        "        == (c != '01voxel'), c\n"
        "for c in ('', '_two_cls'):\n"
        "    cfg = load_config(f'configs/waymo/pp/waymo_centerpoint_pp'\n"
        "                      f'{c}_two_pfn_stride1_3x.py')\n"
        "    det = build_detector(cfg['model'], cfg['train_cfg'],\n"
        "                         cfg['test_cfg'], device='meta')\n"
        "    assert det.input_kind == 'points', c\n"
        "    assert type(det.module.reader).__name__ == 'PillarFeatureNet'\n"
        "    cfg = load_config(f'configs/waymo/pp/two_stage/'\n"
        "                      f'waymo_centerpoint_pp{c}_two_pfn_stride1_'\n"
        "                      f'two_stage_bev_6epoch.py')\n"
        "    det = build_detector(cfg['model'], cfg['train_cfg'],\n"
        "                         cfg['test_cfg'], device='meta')\n"
        "    assert type(det.module.first).__name__ == 'PointPillarsModule'\n"
        "    assert det.module.roi_head.Dense_0.weight.shape[1] == 1921, c\n"
        "cfg = load_config('configs/nusc/voxelnet/'\n"
        "                  'voxelnet_det_cylinder_singlehead.py')\n"
        "det = build_detector(cfg['model'], cfg['train_cfg'], cfg['test_cfg'],\n"
        "                     device='meta')\n"
        "assert type(det.module.bbox_head).__name__ == 'CenterHeadSinglePos'\n"
        "for c, neck in (('1_sector', 'RPNTECP'),\n"
        "                ('4_sector_bidirectional', 'RPNBDCP')):\n"
        "    cfg = load_config(f'configs/nusc/pp/polarstream_det_{c}.py')\n"
        "    det = build_detector(cfg['model'], cfg['train_cfg'],\n"
        "                         cfg['test_cfg'], device='meta')\n"
        "    assert type(det).__name__ == 'PolarStreamDetector', c\n"
        "    assert type(det.module.neck).__name__ == neck, c\n"
        "for c in ('pp/polarstream_det_n_seg_1_sector',\n"
        "          'pp/polarstream_det_n_seg_4_sector_bidirectional',\n"
        "          'pp/polarstream_det_n_seg_4_sector_trailing_edge',\n"
        "          'voxelnet/voxelnet_seg_10sweep',\n"
        "          'voxelnet/voxelnet_seg_cylinder'):\n"
        "    cfg = load_config(f'configs/nusc/{c}.py')\n"
        "    det = build_detector(cfg['model'], cfg['train_cfg'],\n"
        "                         cfg['test_cfg'], device='meta')\n"
        "    assert det.module.seg_head is not None, c\n"
        "    assert 'points_label' in det.loss_keys, c\n"
        "for c, mod in (('han_1_sector', 'PointPillarsModule'),\n"
        "               ('han_4_sectors', 'PolarStreamLSTMModule'),\n"
        "               ('strobe_1_sector', 'StrobeModule'),\n"
        "               ('strobe_4_sector', 'StrobeSectorModule')):\n"
        "    cfg = load_config(f'configs/nusc/pp/{c}.py')\n"
        "    det = build_detector(cfg['model'], cfg['train_cfg'],\n"
        "                         cfg['test_cfg'], device='meta')\n"
        "    assert type(det.module).__name__ == mod, c\n"
        "    assert det.module.seg_head is not None, c\n"
        "    assert det.input_kind == ('sweeps' if 'strobe' in c\n"
        "                              else 'points'), c\n"
        "import glob\n"
        "zoo = sorted(f for f in glob.glob('configs/**/*.py', recursive=True)\n"
        "             if not f.startswith('configs/tests/'))\n"
        "assert len(zoo) == 27, zoo\n"
        "for f in zoo:\n"
        "    cfg = load_config(f)\n"
        "    build_detector(cfg['model'], cfg.get('train_cfg'),\n"
        "                   cfg.get('test_cfg'), device='meta')\n"
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
