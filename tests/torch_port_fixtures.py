"""Shared fixtures of the partner_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages. Every
norm parameter and statistic (and every bias and tau) is randomized before
the weights are converted: with a fresh LayerNorm the keypoint saliency of
the SetBlock is rounding noise, and a comparison would mean nothing.
"""

import copy
import functools

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
NUSC_DCN = "configs/nusc/voxelnet/nusc_centerpoint_voxelnet_dcn.py"
NUSC_01VOXEL = "configs/nusc/voxelnet/nusc_centerpoint_voxelnet_01voxel.py"
NUSC_FLIP = "configs/nusc/voxelnet/nusc_centerpoint_voxelnet_dcn_flip.py"
NUSC_CONFIGS = {"dcn": NUSC_DCN, "01voxel": NUSC_01VOXEL,
                "dcn-flip": NUSC_FLIP}
NUSC_SWEEPS = 3   # the nuScenes configs' 10 sweeps, cut for the CPU
TINY_GRID = (128, 256, 40)  # BEV 32 (az) x 16 (r): exact 8x8 windows
PP = "configs/waymo/pp/waymo_centerpoint_pp_two_pfn_stride1_3x.py"
PP_TWO_CLS = ("configs/waymo/pp/"
              "waymo_centerpoint_pp_two_cls_two_pfn_stride1_3x.py")
PP_CONFIGS = {"three-class": PP, "two-class": PP_TWO_CLS}
PP_TWO_STAGE = ("configs/waymo/pp/two_stage/waymo_centerpoint_pp_two_pfn_"
                "stride1_two_stage_bev_6epoch.py")
PP_TWO_STAGE_TWO_CLS = ("configs/waymo/pp/two_stage/waymo_centerpoint_pp_"
                        "two_cls_two_pfn_stride1_two_stage_bev_6epoch.py")
PP_TWO_STAGE_CONFIGS = {"three-class": PP_TWO_STAGE,
                        "two-class": PP_TWO_STAGE_TWO_CLS}
SINGLEHEAD = "configs/nusc/voxelnet/voxelnet_det_cylinder_singlehead.py"
POLARSTREAM_1 = "configs/nusc/pp/polarstream_det_1_sector.py"
POLARSTREAM_4 = "configs/nusc/pp/polarstream_det_4_sector_bidirectional.py"
POLARSTREAM_CONFIGS = {1: POLARSTREAM_1, 4: POLARSTREAM_4}
# the det + seg PolarStream configs and the seg-only VoxelNet configs
POLARSTREAM_SEG_CONFIGS = {
    n: f"configs/nusc/pp/polarstream_det_n_seg_{n}.py"
    for n in ("1_sector", "4_sector_bidirectional",
              "4_sector_trailing_edge")}
VOXELNET_SEG_CONFIGS = {
    n: f"configs/nusc/voxelnet/voxelnet_seg_{n}.py"
    for n in ("10sweep", "cylinder")}
# the HAN and STROBE configs (cuboid pillars, 512 x 512)
STROBE_HAN_CONFIGS = {
    "han-1": "configs/nusc/pp/han_1_sector.py",
    "han-4": "configs/nusc/pp/han_4_sectors.py",
    "strobe-1": "configs/nusc/pp/strobe_1_sector.py",
    "strobe-4": "configs/nusc/pp/strobe_4_sector.py"}
STROBE_GRID = 64    # their pillar grid cut to 64 x 64 (voxel size x 8)
STROBE_PILLARS = 2048   # the tiny cut's pillar capacity (a sector)
POLAR_GRID = (64, 128)   # (n_r, n_az) pillars, cut from 512 x 512
PP_GRID = 64        # the pillar grid, cut from 468 x 468 to 64 x 64
PP_PILLARS = 512    # the tiny configs' pillar capacity: the sweeps overflow it


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


def head_cfg(config):
    """A config's bbox_head rewritten as ``build_voxelnet`` rewrites it in
    both packages (tasks as tuples, common_heads sorted, detector keys
    taken out)."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bh = copy.deepcopy(load_config(os.path.join(root, config))["model"][
        "bbox_head"])
    for k in ("voxel_shape", "code_weights", "weight", "dataset",
              "voxel_generator"):
        bh.pop(k, None)
    bh["tasks"] = tuple({"class_names": tuple(t["class_names"])}
                        for t in bh["tasks"])
    bh["common_heads"] = tuple(sorted((k, tuple(v)) for k, v in
                                      bh["common_heads"].items()))
    return bh


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


def _cut_pp(m, max_pillars):
    """A PointPillars model cfg cut in place to a ``PP_GRID`` square
    pillar grid (the reader's cell size too), PFN filters [16, 16], a
    narrow three-scale RPN (48 channels out) and ``max_pillars``."""
    vg = m["bbox_head"]["voxel_generator"]
    pr = vg["range"]
    vg["voxel_size"] = [(pr[3] - pr[0]) / PP_GRID, (pr[4] - pr[1]) / PP_GRID,
                        vg["voxel_size"][2]]
    m["reader"] = dict(m["reader"], num_filters=[16, 16],
                       voxel_size=tuple(vg["voxel_size"]))
    m["neck"] = dict(m["neck"], layer_nums=[1, 1, 1],
                     ds_num_filters=[16, 16, 32], us_num_filters=[16, 16, 16],
                     num_input_features=16)
    m["bbox_head"]["in_channels"] = 48
    m["max_pillars"] = max_pillars


def tiny_pp_cfg(config=PP, max_pillars=PP_PILLARS):
    """(model cfg, test cfg): a Waymo PointPillars config cut as
    :func:`_cut_pp` cuts it (float32, as the configs are), the NMS cut as
    in :func:`tiny_frame_cfg`."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, config))
    m = copy.deepcopy(cfg["model"])
    _cut_pp(m, max_pillars)
    return m, _tiny_test_cfg(cfg)


_POLAR_CUT = f"""
_vg = model["bbox_head"]["voxel_generator"]
_r = _vg["range"]
_vg["voxel_size"] = [(_r[3] - _r[0]) / {POLAR_GRID[0]},
                     (_r[4] - _r[1]) / {POLAR_GRID[1]}, _vg["voxel_size"][2]]
model["reader"].update(num_filters=[16, 16])
model["neck"].update(layer_nums=[1, 1, 1], ds_num_filters=[16, 16, 32],
                     us_num_filters=[16, 16, 16], num_input_features=16)
model["bbox_head"]["in_channels"] = 48
"""


def _cut_polarstream(m, max_pillars):
    """A PolarStream model cfg cut in place to the ``POLAR_GRID`` pillar
    grid (the configs' range), PFN filters [16, 16], a narrow three-scale
    stream neck (48 channels out, every ``us_layer_strides`` kept) and,
    where given, ``max_pillars`` a sector."""
    scope = {"model": m}
    exec(_POLAR_CUT, scope)
    if max_pillars is not None:
        m["max_pillars"] = max_pillars


def tiny_polarstream_cfg(config=POLARSTREAM_4, max_pillars=None):
    """(model cfg, test cfg): a PolarStream config cut as
    :func:`_cut_polarstream` cuts it (float32, as the configs are), the
    NMS cut as in :func:`tiny_frame_cfg` but its 83 kept boxes a sector."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, config))
    m = copy.deepcopy(cfg["model"])
    _cut_polarstream(m, max_pillars)
    tc = copy.deepcopy(cfg["test_cfg"])
    tc["score_threshold"] = 0.0
    tc["nms"] = dict(tc["nms"], nms_pre_max_size=256)
    return m, tc


def write_tiny_polarstream_config(path, train_info, val_info, root,
                                  config=POLARSTREAM_4, max_pillars=None):
    """A PolarStream config file for the CLIs: ``config`` exec'd, cut as
    :func:`tiny_polarstream_cfg` cuts it, ``nsweeps`` cut to
    ``NUSC_SWEEPS``, ``data.train`` at ``train_info`` with no augmentation
    and the points kept in order (no random draw), ``data.val`` at
    ``val_info``, one loader thread, a log flush and a ``metrics.jsonl``
    record every step."""
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), config)
    with open(path, "w") as f:
        f.write(f"""
__file__ = {base!r}
exec(open({base!r}).read())
{_POLAR_CUT}
if {max_pillars!r} is not None:
    model["max_pillars"] = {max_pillars!r}
test_cfg["score_threshold"] = 0.0
test_cfg["nms"].update(nms_pre_max_size=256)
train_preprocessor.update(no_augmentation=True, shuffle_points=False)
for _s, _info in (("train", {train_info!r}), ("val", {val_info!r})):
    data[_s].update(info_path=_info, root_path={root!r},
                    nsweeps={NUSC_SWEEPS})
    for _p in data[_s]["pipeline"]:
        if _p["type"] == "Voxelization":
            _p["cfg"] = _vg
data["workers_per_gpu"] = 1
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook"),
                                     dict(type="MetricsSinkHook")])
""")
    return path


_STROBE_CUT = f"""
_vg = model["bbox_head"]["voxel_generator"]
_vg["voxel_size"] = [_vg["voxel_size"][0] * 8, _vg["voxel_size"][1] * 8,
                     _vg["voxel_size"][2]]
model["reader"].update(num_filters=[16, 16])
model["neck"].update(layer_nums=[1, 1, 1], ds_num_filters=[16, 16, 32],
                     us_num_filters=[16, 16, 16], num_input_features=16)
model["bbox_head"]["in_channels"] = 48
model["max_pillars"] = {STROBE_PILLARS}
"""


def tiny_strobe_cfg(config, variant=None):
    """(model cfg, test cfg): a HAN or STROBE config
    (``STROBE_HAN_CONFIGS``) cut to the ``STROBE_GRID`` pillar grid
    (the voxel size x 8, ``tests/test_config_zoo.py``'s rule), PFN filters
    [16, 16], a narrow three-scale neck (48 channels out, every
    ``us_layer_strides`` kept) and ``STROBE_PILLARS`` pillars; ``variant``
    renames a STROBE model (``STROBEV2``, ``STROBEV3``). The NMS cut as in
    :func:`tiny_polarstream_cfg`."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, config))
    m = copy.deepcopy(cfg["model"])
    exec(_STROBE_CUT, {"model": m})
    if variant is not None:
        m["type"] = variant
    tc = copy.deepcopy(cfg["test_cfg"])
    tc["score_threshold"] = 0.0
    tc["nms"] = dict(tc["nms"], nms_pre_max_size=256)
    return m, tc


def write_tiny_strobe_config(path, train_info, val_info, root, config):
    """A HAN or STROBE config file for the CLIs: ``config`` exec'd, cut as
    :func:`tiny_strobe_cfg` cuts it, ``nsweeps`` cut to ``NUSC_SWEEPS``,
    every pipeline's ``Voxelization`` at the model's grid, ``data.train``
    at ``train_info`` with no augmentation and the points kept in order,
    ``data.val`` at ``val_info``, one loader thread, a log flush and a
    ``metrics.jsonl`` record every step."""
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), config)
    with open(path, "w") as f:
        f.write(f"""
__file__ = {base!r}
exec(open({base!r}).read())
{_STROBE_CUT}
test_cfg["score_threshold"] = 0.0
test_cfg["nms"].update(nms_pre_max_size=256)
train_preprocessor.update(no_augmentation=True, shuffle_points=False)
for _s, _info in (("train", {train_info!r}), ("val", {val_info!r})):
    data[_s].update(info_path=_info, root_path={root!r},
                    nsweeps={NUSC_SWEEPS})
    for _p in data[_s]["pipeline"]:
        if _p["type"] == "Voxelization":
            _p["cfg"] = _vg
data["workers_per_gpu"] = 1
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook"),
                                     dict(type="MetricsSinkHook")])
""")
    return path


def cuboid_points(rng, pc_range, n_points, n_pad, cell, margin=1e-3,
                  wedge=None):
    """(1, n_pad, 7) cuboid-layout points [x, y, z, intensity, time lag,
    rho, phi] (:func:`pp_points` drawn; with ``wedge`` (lo, hi) 2/3 of
    them turned into that azimuth wedge) and their (1, n_pad) mask, every
    x and y moved at least ``margin`` off the multiples of ``cell`` (the
    pillar edges, the axes among them; ``margin`` 0 leaves them): a cuboid
    sector turns its points by ``cos`` / ``sin``, which XLA and torch
    round apart by an ulp, so a point within an ulp of an edge could
    change pillar or sector."""
    pts, mask = pp_points(rng, pc_range, n_points, n_pad)
    xy = pts[0, :n_points, :2].astype(np.float64)
    if wedge is not None:
        k = 2 * n_points // 3
        rho = np.hypot(xy[:k, 0], xy[:k, 1])
        phi = rng.uniform(wedge[0], wedge[1], k)
        xy[:k] = np.stack([rho * np.cos(phi), rho * np.sin(phi)], 1)
    k = np.round(xy / cell)
    near = np.abs(xy - k * cell) < margin
    xy = np.where(near, k * cell + np.where(xy >= k * cell, 1, -1) * margin
                  * 2, xy)
    pts[0, :n_points, :2] = xy
    pts[0, :n_points, 5] = np.hypot(xy[:, 0], xy[:, 1])
    pts[0, :n_points, 6] = np.arctan2(xy[:, 1], xy[:, 0])
    return pts, mask


def pp_points(rng, pc_range, n_points, n_pad, dup=0):
    """(1, n_pad, 7) cuboid-layout points [x, y, z, intensity, elongation,
    rho, phi] and a (1, n_pad) mask: log-uniform range as a lidar sees it,
    a few points beyond the grid, and the last ``dup`` points copies of
    earlier ones (tied maxima in their pillars)."""
    rho = np.exp(rng.uniform(np.log(0.5), np.log(pc_range[3] * 1.45),
                             n_points))
    phi = rng.uniform(-np.pi, np.pi, n_points)
    x, y = rho * np.cos(phi), rho * np.sin(phi)
    z = rng.uniform(pc_range[2] - 0.5, pc_range[5] + 0.5, n_points)
    pts = np.stack([x, y, z, rng.rand(n_points), rng.rand(n_points),
                    np.hypot(x, y), np.arctan2(y, x)], 1).astype(np.float32)
    if dup:
        pts[-dup:] = pts[rng.randint(0, n_points - dup, dup)]
    out = np.zeros((1, n_pad, 7), np.float32)
    out[0, :n_points] = pts
    mask = np.zeros((1, n_pad), bool)
    mask[0, :n_points] = True
    return out, mask


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


def tiny_pp_two_stage_cfg(config=PP_TWO_STAGE, max_pillars=PP_PILLARS):
    """(model cfg, test cfg): a PointPillars two-stage config whose first
    stage is cut as :func:`tiny_pp_cfg` cuts a one-stage one (so the RoI
    head takes 5 x 48 + 1 inputs), the NMS cut likewise."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, config))
    m = copy.deepcopy(cfg["model"])
    _cut_pp(m["first_stage_cfg"], max_pillars)
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


def write_tiny_nusc_set(root, seed=3, n_frames=4, n_points=1500,
                        n_boxes=12, lidarseg=False):
    """A synthetic nuScenes set of ``n_frames`` key frames with
    ``NUSC_SWEEPS - 1`` earlier sweeps each under ``root``, its infos made
    by the port's ``create_data nuscenes_data_prep``
    (``chip_smoke.write_nusc_scene``; with ``lidarseg`` a lidarseg file a
    key frame and its ``lidarseg_path``) -> the infos' path."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.write_nusc_scene(root, np.random.RandomState(seed),
                                       n_frames, NUSC_SWEEPS, n_points,
                                       n_boxes=n_boxes, lidarseg=lidarseg)


def nusc_batch(config, model_cfg, info_path, root, mode, samples, seed=0,
               max_points=5000, n_sectors=None):
    """The first ``samples`` frames of the nuScenes infos at ``info_path``
    through ``config``'s ``mode`` pipeline in the port (``nsweeps`` cut to
    ``NUSC_SWEEPS``, ``Voxelization`` on ``model_cfg``'s grid (its
    ``bbox_head``'s, or a seg-only model's ``seg_head``'s), the draws
    from ``RandomState(seed)``), collated: the batch the CLIs hand the
    detector (the double-flip pipeline's 4 rows a sample). ``n_sectors``
    sets each ``AssignLabel``'s sector count as the train CLI sets it to
    the model's (``tools.train.sector_targets``)."""
    import os

    import partner_tpu_torch.data as tdata
    from partner_tpu_torch.data.collate import collate
    from partner_tpu_torch.utils.config import load_config

    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ds = copy.deepcopy(load_config(os.path.join(base, config))["data"][mode])
    ds.update(info_path=info_path, root_path=root, nsweeps=NUSC_SWEEPS)
    spec = model_cfg.get("bbox_head") or model_cfg["seg_head"]
    for p in ds["pipeline"]:
        if p["type"] == "Voxelization":
            p["cfg"] = copy.deepcopy(spec["voxel_generator"])
    if n_sectors is not None:
        import logging

        from partner_tpu_torch.tools.train import sector_targets

        ds = sector_targets(ds, n_sectors, logging.getLogger(__name__),
                            config)
    data = tdata.build_dataset(ds, dict(rng=np.random.RandomState(seed)))
    return collate([data[i] for i in range(samples)], max_points=max_points)


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


def randomize_dcn(variables, rng):
    """:func:`randomize`, and every zero-initialized ``conv_offset`` kernel
    of a DCN branch drawn too (N(0, 0.05)), so the learned offsets vary
    from cell to cell (a fresh branch's are its bias alone)."""
    v = randomize(variables, rng)

    def walk(tree):
        for k, sub in tree.items():
            if not isinstance(sub, dict):
                continue
            if k == "conv_offset":
                sub["kernel"] = rng.normal(0.0, 0.05, sub["kernel"].shape
                                           ).astype(np.float32)
            walk(sub)

    walk(v)
    return v


def drawn_init(init, rng, *args, **kwargs):
    """Numpy variables of the shapes ``init(PRNGKey(0), *args, **kwargs)``
    makes, traced but not compiled (``jax.eval_shape``; a jitted flax
    init compiles every initializer's threefry draws, ~15 s for a
    nuScenes detector on the CPU), every float leaf drawn from ``rng``
    N(0, 1 / fan_in) (fan_in the product of all but its last axis): the
    kernels a test keeps, and placeholders of the norms, biases and
    statistics that :func:`randomize` draws after."""
    import jax

    shapes = jax.eval_shape(functools.partial(init, **kwargs),
                            jax.random.PRNGKey(0), *args)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif np.issubdtype(v.dtype, np.floating):
                fan_in = max(1, int(np.prod(v.shape[:-1])))
                out[k] = (rng.normal(0.0, fan_in ** -0.5, v.shape)
                          .astype(v.dtype))
            else:
                out[k] = np.zeros(v.shape, v.dtype)
        return out

    return walk(shapes)


def nusc_jax_variables(jdet, rng, c=7, flax_init=False):
    """A JAX nuScenes detector's variables from a 7-column point example,
    drawn (:func:`drawn_init`; with ``flax_init`` the kernels of
    ``jdet.init`` kept instead) and :func:`randomize_dcn`ed."""
    import jax

    ex = {"points": np.zeros((1, 64, c), np.float32),
          "points_mask": np.zeros((1, 64), bool)}
    if flax_init:
        return randomize_dcn(jdet.init(jax.random.PRNGKey(0), ex), rng)
    return randomize_dcn(drawn_init(jdet.module.init, rng, ex, train=False),
                         rng)


def assert_same_detections(got, want, box_tol=1e-4, score_tol=1e-5,
                           tie=1e-6):
    """One frame's kept detections (``box3d_lidar``, ``scores``,
    ``label_preds``, in score order) against the reference's: the same
    count, and each row within ``box_tol`` / ``score_tol`` of the
    reference's row at its place, or, where the reference's scores tie
    within ``tie`` (a float32 tie, which another summation order may break
    the other way), of a row of that tie."""
    n = len(want["scores"])
    assert len(got["scores"]) == n
    ws = np.asarray(want["scores"])
    for i in range(n):
        near = np.flatnonzero(np.abs(ws - ws[i]) <= tie)
        ok = [k for k in near
              if got["label_preds"][i] == want["label_preds"][k]
              and np.abs(got["box3d_lidar"][i]
                         - want["box3d_lidar"][k]).max() <= box_tol
              and abs(got["scores"][i] - ws[k]) <= score_tol]
        assert ok, (i, got["box3d_lidar"][i], want["box3d_lidar"][i])


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


def write_tiny_pp_config(path, train_info, val_info, root, config=PP,
                         max_pillars=PP_PILLARS):
    """A PointPillars config file for the CLIs: ``config`` exec'd, cut as
    :func:`_cut_pp` cuts it, ``data.train`` at ``train_info`` with no
    augmentation and the points kept in order (no random draw),
    ``data.val`` at ``val_info``, one loader thread, a log flush and a
    ``metrics.jsonl`` record every step."""
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), config)
    with open(path, "w") as f:
        f.write(f"""
__file__ = {base!r}
exec(open({base!r}).read())
_vg = model["bbox_head"]["voxel_generator"]
_r = _vg["range"]
_vg["voxel_size"] = [(_r[3] - _r[0]) / {PP_GRID}, (_r[4] - _r[1]) / {PP_GRID},
                     _vg["voxel_size"][2]]
model["reader"].update(num_filters=[16, 16],
                       voxel_size=tuple(_vg["voxel_size"]))
model["neck"].update(layer_nums=[1, 1, 1], ds_num_filters=[16, 16, 32],
                     us_num_filters=[16, 16, 16], num_input_features=16)
model["bbox_head"]["in_channels"] = 48
model["max_pillars"] = {max_pillars!r}
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


def write_tiny_pp_two_stage_config(path, train_info, val_info, root,
                                   config=PP_TWO_STAGE, pretrained=None,
                                   max_pillars=PP_PILLARS):
    """A PointPillars two-stage config file for the CLIs: ``config``
    exec'd, its first stage cut as :func:`_cut_pp` cuts a one-stage one
    (the pipelines' grid too), its ``pretrained`` set, ``data.train`` at
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
_r = _vg["range"]
_vg["voxel_size"] = [(_r[3] - _r[0]) / {PP_GRID}, (_r[4] - _r[1]) / {PP_GRID},
                     _vg["voxel_size"][2]]
_fs["reader"] = dict(_fs["reader"], num_filters=[16, 16],
                     voxel_size=tuple(_vg["voxel_size"]))
_fs["neck"] = dict(_fs["neck"], layer_nums=[1, 1, 1],
                   ds_num_filters=[16, 16, 32], us_num_filters=[16, 16, 16],
                   num_input_features=16)
_fs["bbox_head"]["in_channels"] = 48
_fs["max_pillars"] = {max_pillars!r}
_fs["pretrained"] = {pretrained!r}
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


VOXSEG_GRID = (64, 128, 40)  # (n_r|x, n_az|y, z): BEV 16 (rows) x 8 (cols)
_VOXSEG_CUT = f"""
_vg = model["seg_head"]["voxel_generator"]
_r = _vg["range"]
_vg["voxel_size"] = [(_r[3 + _i] - _r[_i]) / {VOXSEG_GRID}[_i]
                     for _i in range(3)]
_vg["max_voxel_num"] = [4000, 4000]
model["neck"].update(layer_nums=[1, 1], ds_num_filters=[16, 32],
                     us_num_filters=[32, 32])
"""


def tiny_voxelnet_seg_cfg(config):
    """(model cfg, test cfg): a seg-only VoxelNet config
    (``VOXELNET_SEG_CONFIGS``) cut to ``VOXSEG_GRID`` (the sparse backbone
    at full width, 40 layers), a narrow RPN (64 channels out) and 4,000
    voxels; its ``DeconvConvHead`` as it is (height 40, up_scale 8)."""
    import os

    from partner_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, config))
    m = copy.deepcopy(cfg["model"])
    exec(_VOXSEG_CUT, {"model": m})
    return m, copy.deepcopy(cfg["test_cfg"])


def write_tiny_voxelnet_seg_config(path, train_info, val_info, root,
                                   config):
    """A seg-only VoxelNet config file for the CLIs: ``config`` exec'd, cut
    as :func:`tiny_voxelnet_seg_cfg` cuts it (the config's
    ``voxel_generator``, which its pipelines and seg head share),
    ``nsweeps`` cut to ``NUSC_SWEEPS``, ``data.train`` at ``train_info``
    with no augmentation and the points kept in order, ``data.val`` at
    ``val_info``, one loader thread, a log flush and a ``metrics.jsonl``
    record every step."""
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), config)
    with open(path, "w") as f:
        f.write(f"""
__file__ = {base!r}
exec(open({base!r}).read())
{_VOXSEG_CUT}
assert voxel_generator is _vg
train_preprocessor.update(no_augmentation=True, shuffle_points=False)
for _s, _info in (("train", {train_info!r}), ("val", {val_info!r})):
    data[_s].update(info_path=_info, root_path={root!r},
                    nsweeps={NUSC_SWEEPS})
data["workers_per_gpu"] = 1
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook"),
                                     dict(type="MetricsSinkHook")])
""")
    return path


def write_tiny_nusc_config(path, train_info, val_info, root, config):
    """A nuScenes CenterPoint config file for the CLIs: ``config`` exec'd
    and cut as :func:`write_tiny_centerpoint_config` cuts a Waymo one,
    ``nsweeps`` cut to ``NUSC_SWEEPS``, and every pipeline's
    ``Voxelization`` pointed at the model's grid. The last matters for the
    01voxel config, whose pipelines keep the DCN config's 1024 x 1024 grid
    (ROADMAP.md §3), so the targets would not fit its head's maps."""
    write_tiny_centerpoint_config(path, train_info, val_info, root,
                                  config=config)
    with open(path, "a") as f:
        f.write(f"""
for _s in ("train", "val"):
    data[_s]["nsweeps"] = {NUSC_SWEEPS}
    for _p in data[_s]["pipeline"]:
        if _p["type"] == "Voxelization":
            _p["cfg"] = voxel_generator
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


def write_three_class_infos(path, rng, n=4, n_points=(3000, 5000),
                            upper=False):
    """A synthetic Waymo info pkl of ``n`` frames that carry their points:
    [x, y, z, intensity, elongation] rows within 34 m, and 3-8 boxes each
    of Vehicle, Pedestrian and Cyclist sizes (9 columns, the velocity
    included), named in upper case with ``upper`` (as the PointPillars
    configs name their classes)."""
    import pickle

    sizes = {"Vehicle": (4.5, 2.0, 1.6), "Pedestrian": (0.8, 0.8, 1.8),
             "Cyclist": (1.8, 0.7, 1.7)}
    if upper:
        sizes = {k.upper(): v for k, v in sizes.items()}
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
