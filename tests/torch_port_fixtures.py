"""Shared fixtures of the partner_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages. Every
norm parameter and statistic (and every bias and tau) is randomized before
the weights are converted: with a fresh LayerNorm the keypoint saliency of
the SetBlock is rounding noise, and a comparison would mean nothing.
"""

import copy

import numpy as np

FLAGSHIP = "configs/waymo/waymo_partner_36epoch.py"
CENTERPOINT = "configs/waymo/waymo_centerpoint_voxelnet_36epoch.py"
CENTERPOINT_VELO = ("configs/waymo/"
                    "waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py")
TWO_STAGE = ("configs/waymo/two_stage/"
             "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_"
             "freeze.py")
TWO_STAGE_VELO = ("configs/waymo/two_stage/"
                  "waymo_centerpoint_voxelnet_two_sweep_two_stage_bev_"
                  "5point_ft_6epoch_freeze_with_vel.py")
TINY_GRID = (128, 256, 40)  # BEV 32 (az) x 16 (r): exact 8x8 windows


def tiny_frame_cfg(compute_dtype="float32"):
    """(model cfg, test cfg): the flagship config at a tiny, exactly tiling
    grid and narrow widths, built in float32 on both sides."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, FLAGSHIP))
    m = copy.deepcopy(cfg["model"])
    bh = dict(m["bbox_head"])
    vg = dict(bh["voxel_generator"])
    pr = vg["range"]
    vg["voxel_size"] = [(pr[3 + i] - pr[i]) / TINY_GRID[i] for i in range(3)]
    bh["voxel_generator"] = vg
    bh["in_channels"] = 64
    bh["HEAD_CONFIG"] = dict(bh["HEAD_CONFIG"], compute_dtype=compute_dtype)
    m["bbox_head"] = bh
    m["backbone"] = dict(m["backbone"], a2d_features=32, out_features=32,
                         compute_dtype=compute_dtype)
    m["neck"] = dict(m["neck"], layer_nums=[1, 1], ds_num_filters=[16, 32],
                     us_num_filters=[32, 32], num_input_features=32,
                     compute_dtype=compute_dtype)
    tc = copy.deepcopy(cfg["test_cfg"])
    # random weights put almost every score under the flagship's 0.1
    # threshold; 0 makes the NMS do real work
    tc["score_threshold"] = 0.0
    tc["nms"] = dict(tc["nms"], nms_pre_max_size=256, nms_post_max_size=64)
    return m, tc


def tiny_centerpoint_cfg(config=CENTERPOINT, compute_dtype="float32"):
    """(model cfg, test cfg): a CenterPoint config at ``TINY_GRID`` with a
    narrow RPN (the backbone keeps its stem and 3D trunk widths), built in
    ``compute_dtype`` on both sides; the NMS cut as in
    :func:`tiny_frame_cfg`."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, config))
    m = copy.deepcopy(cfg["model"])
    _cut_centerpoint(m, compute_dtype)
    return m, _tiny_test_cfg(cfg)


def _cut_centerpoint(m, compute_dtype):
    """A VoxelNet model cfg cut in place to ``TINY_GRID`` and a narrow RPN
    (64 BEV channels)."""
    bh = m["bbox_head"]
    vg = bh["voxel_generator"]
    pr = vg["range"]
    vg["voxel_size"] = [(pr[3 + i] - pr[i]) / TINY_GRID[i] for i in range(3)]
    bh["in_channels"] = 64
    m["backbone"] = dict(m["backbone"], compute_dtype=compute_dtype)
    m["neck"] = dict(m["neck"], layer_nums=[1, 1], ds_num_filters=[16, 32],
                     us_num_filters=[32, 32], compute_dtype=compute_dtype)


def _tiny_test_cfg(cfg):
    tc = copy.deepcopy(cfg["test_cfg"])
    tc["score_threshold"] = 0.0
    tc["nms"] = dict(tc["nms"], nms_pre_max_size=256, nms_post_max_size=64)
    return tc


def tiny_two_stage_cfg(config=TWO_STAGE, freeze=None,
                       compute_dtype="float32"):
    """(model cfg, test cfg): a two-stage config whose first stage is cut
    as :func:`tiny_centerpoint_cfg` cuts a CenterPoint config (so the RoI
    head takes 5 x 64 + 1 inputs at its config's widths), ``freeze`` set
    where given, the NMS cut likewise."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, config))
    m = copy.deepcopy(cfg["model"])
    _cut_centerpoint(m["first_stage_cfg"], compute_dtype)
    if freeze is not None:
        m["freeze"] = freeze
    return m, _tiny_test_cfg(cfg)


SPARSE_BEV = 256  # SpMiddleResNetFHD's BEV width on a 40-layer grid


def with_sparse_backbone(m, index_method="binary"):
    """A copy of a VoxelNet / VoxelNetV3 model cfg with ``backbone``
    replaced by the sparse ``SpMiddleResNetFHD`` (its input width kept)
    and the neck taking its BEV width."""
    m = copy.deepcopy(m)
    m["backbone"] = dict(type="SpMiddleResNetFHD",
                         num_input_features=m["backbone"][
                             "num_input_features"],
                         index_method=index_method)
    m["neck"] = dict(m["neck"], num_input_features=SPARSE_BEV)
    return m


def synthetic_points(rng, pc_range, n_points, n_pad, c=7):
    """(1, n_pad, c) cylinder-layout points [rho, phi, z, x, y, ...] and a
    (1, n_pad) mask; a few points fall outside the grid."""
    rho = rng.uniform(pc_range[0] - 1.0, pc_range[3] + 1.0, n_points)
    phi = rng.uniform(pc_range[1], pc_range[4], n_points)
    z = rng.uniform(pc_range[2] - 0.5, pc_range[5] + 0.5, n_points)
    cols = [rho, phi, z, rho * np.cos(phi), rho * np.sin(phi)]
    while len(cols) < c:
        cols.append(rng.rand(n_points))
    pts = np.zeros((1, n_pad, c), np.float32)
    pts[0, :n_points] = np.stack(cols[:c], 1)
    mask = np.zeros((1, n_pad), bool)
    mask[0, :n_points] = True
    return pts, mask


def jax_init(module, *args, **kwargs):
    """Jitted flax init (eager init compiles op by op and is ~4x slower)."""
    import functools

    import jax

    return jax.jit(functools.partial(module.init, **kwargs))(
        jax.random.PRNGKey(0), *args)


def jax_apply(module, variables, *args, **kwargs):
    """Jitted flax apply, as numpy."""
    import functools

    import jax

    out = jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)
    return jax.tree_util.tree_map(np.asarray, out)


def numpy_tree(tree):
    return {k: numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def randomize(variables, rng):
    """Numpy copy of flax variables with every scale/bias/tau parameter and
    every mean/var statistic drawn from ``rng``."""

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k.endswith("scale") or k == "tau":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k.endswith("bias") or k.endswith("mean"):
                v = rng.normal(0.0, 0.2, v.shape)
            elif k.endswith("var"):
                v = rng.uniform(0.5, 1.5, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(numpy_tree(variables))


def load_converted(module, variables):
    """Load converted flax variables strictly; returns the module."""
    from partner_tpu_torch.convert import flax_to_torch

    module.load_state_dict(flax_to_torch(variables), strict=True)
    return module.eval()


def write_tiny_eval_config(path, info_path, root):
    """A config file for the CLIs: the flagship config exec'd, then cut to
    ``tiny_frame_cfg``'s grid and widths (float32), ``data.val`` pointed at
    ``info_path``; both dist_test CLIs read it."""
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), FLAGSHIP)
    with open(path, "w") as f:
        f.write(f"""
exec(open({base!r}).read())
_pr = voxel_generator["range"]
voxel_generator["voxel_size"] = [(_pr[3 + i] - _pr[i]) / g
                                 for i, g in enumerate({TINY_GRID!r})]
bbox_head["in_channels"] = 64
bbox_head["HEAD_CONFIG"]["compute_dtype"] = "float32"
model["backbone"].update(a2d_features=32, out_features=32,
                         compute_dtype="float32")
model["neck"].update(layer_nums=[1, 1], ds_num_filters=[16, 32],
                     us_num_filters=[32, 32], num_input_features=32,
                     compute_dtype="float32")
test_cfg["score_threshold"] = 0.0
test_cfg["nms"].update(nms_pre_max_size=256, nms_post_max_size=64)
data["val"].update(info_path={info_path!r}, root_path={root!r})
""")
    return path


def write_tiny_train_config(path, info_path, root, val_info_path=None):
    """A train config file for the CLIs: ``write_tiny_eval_config``'s cut
    of the flagship config, plus ``data.train`` at ``info_path`` with every
    drop rate 0, ``no_augmentation`` and no GT-AUG (no random draw
    anywhere, so the two packages' runs can be compared step by step), the
    points kept in order, one loader thread, a log flush and a
    ``metrics.jsonl`` record every step, and ``data.val`` at
    ``val_info_path`` (``info_path`` when None)."""
    write_tiny_eval_config(path, val_info_path or info_path, root)
    with open(path, "a") as f:
        f.write(f"""
model["neck"].update(set_drop=0.0, set_attn_drop=0.0, set_drop_path=0.0)
train_preprocessor.update(no_augmentation=True, shuffle_points=False)
db_sampler["enable"] = False
data["train"].update(info_path={info_path!r}, root_path={root!r})
data["workers_per_gpu"] = 1
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook"),
                                     dict(type="MetricsSinkHook")])
""")
    return path


def write_tiny_centerpoint_config(path, train_info, val_info, root,
                                  config=CENTERPOINT):
    """A CenterPoint config file for the CLIs: ``config`` exec'd, then cut
    as :func:`tiny_centerpoint_cfg` cuts it (float32), ``data.train`` at
    ``train_info`` with no augmentation and the points kept in order (no
    random draw), ``data.val`` at ``val_info``, one loader thread, a log
    flush and a ``metrics.jsonl`` record every step."""
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), config)
    with open(path, "w") as f:
        # the config's own path, for a config that reads a sibling file
        f.write(f"""
__file__ = {base!r}
exec(open({base!r}).read())
_pr = voxel_generator["range"]
voxel_generator["voxel_size"] = [(_pr[3 + i] - _pr[i]) / g
                                 for i, g in enumerate({TINY_GRID!r})]
bbox_head["in_channels"] = 64
model["backbone"].update(compute_dtype="float32")
model["neck"].update(layer_nums=[1, 1], ds_num_filters=[16, 32],
                     us_num_filters=[32, 32], compute_dtype="float32")
test_cfg["score_threshold"] = 0.0
test_cfg["nms"].update(nms_pre_max_size=256, nms_post_max_size=64)
train_preprocessor.update(no_augmentation=True, shuffle_points=False)
data["train"].update(info_path={train_info!r}, root_path={root!r})
data["val"].update(info_path={val_info!r}, root_path={root!r})
data["workers_per_gpu"] = 1
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook"),
                                     dict(type="MetricsSinkHook")])
""")
    return path


def write_tiny_two_stage_config(path, train_info, val_info, root,
                                config=TWO_STAGE, freeze=True,
                                pretrained=None):
    """A two-stage config file for the CLIs: ``config`` exec'd, its first
    stage cut as :func:`tiny_two_stage_cfg` cuts it (float32), ``freeze``
    and the first stage's ``pretrained`` set, ``data.train`` at
    ``train_info`` with no augmentation and the points kept in order,
    ``data.val`` at ``val_info``, one loader thread, a log flush and a
    ``metrics.jsonl`` record every step."""
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), config)
    with open(path, "w") as f:
        f.write(f"""
__file__ = {base!r}
exec(open({base!r}).read())
_fs = model["first_stage_cfg"]
_vg = _fs["bbox_head"]["voxel_generator"]
_vg["voxel_size"] = [(_vg["range"][3 + i] - _vg["range"][i]) / g
                     for i, g in enumerate({TINY_GRID!r})]
_fs["bbox_head"]["in_channels"] = 64
_fs["backbone"].update(compute_dtype="float32")
_fs["neck"].update(layer_nums=[1, 1], ds_num_filters=[16, 32],
                   us_num_filters=[32, 32], compute_dtype="float32")
_fs["pretrained"] = {pretrained!r}
model["freeze"] = {freeze!r}
test_cfg["score_threshold"] = 0.0
test_cfg["nms"].update(nms_pre_max_size=256, nms_post_max_size=64)
for _p in data["train"]["pipeline"]:
    if _p["type"] == "Preprocess":
        _p["cfg"].update(no_augmentation=True, shuffle_points=False)
data["train"].update(info_path={train_info!r}, root_path={root!r})
data["val"].update(info_path={val_info!r}, root_path={root!r})
data["workers_per_gpu"] = 1
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook"),
                                     dict(type="MetricsSinkHook")])
""")
    return path


def write_three_class_infos(path, rng, n=4, n_points=(3000, 5000)):
    """A synthetic Waymo info pkl of ``n`` frames that carry their points:
    [x, y, z, intensity, elongation] rows within 34 m, and 3-8 boxes each
    of Vehicle, Pedestrian and Cyclist sizes (9 columns, the velocity
    included)."""
    import pickle

    sizes = {"Vehicle": (4.5, 2.0, 1.6), "Pedestrian": (0.8, 0.8, 1.8),
             "Cyclist": (1.8, 0.7, 1.7)}
    infos = []
    for i in range(n):
        npts = rng.randint(*n_points)
        r = rng.uniform(1, 34, npts)
        th = rng.uniform(-np.pi, np.pi, npts)
        pts = np.stack([r * np.cos(th), r * np.sin(th),
                        rng.uniform(-1.5, 2.5, npts), rng.rand(npts),
                        rng.rand(npts)], 1).astype(np.float32)
        nb = rng.randint(3, 9)
        names = np.array(list(sizes))[rng.randint(0, 3, nb)]
        names[:3] = list(sizes)      # every class in every frame
        boxes = np.zeros((nb, 9), np.float32)
        rho, phi = rng.uniform(5, 30, nb), rng.uniform(-2.5, 2.5, nb)
        boxes[:, 0], boxes[:, 1] = rho * np.cos(phi), rho * np.sin(phi)
        boxes[:, 2] = rng.uniform(-0.5, 0.5, nb)
        boxes[:, 3:6] = [sizes[nm] for nm in names]
        boxes[:, 6:8] = rng.randn(nb, 2)
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, nb)
        infos.append({"token": f"frame{i}", "points": pts, "gt_boxes": boxes,
                      "gt_names": names})
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path
