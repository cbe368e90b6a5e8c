"""The mesh of partner_tpu_torch against the JAX package's, without ranks:
the model axis's placement at full width, the rank order, and the stops
of ``parallel.mesh.check``.

The placement is JAX's ``param_sharding`` (``partner_tpu/parallel/
mesh.py:93-143``) over ``jax.eval_shape`` of each detector's init (shapes
only, no compute), on a ``model`` axis of 2 (and 4 for the flagship) of
virtual CPU devices; the port's ``parallel.tp.placement`` reads the same
rule off the flax shapes that ``convert.flax_leaf`` gives its
parameters, on a detector built on the meta device. The two sets of
sliced tensors, JAX's mapped to the port's names through
``convert.torch_param_name``, must be equal.
"""

import functools
import os

import jax
import numpy as np
import pytest

from torch_port_fixtures import (CENTERPOINT, FLAGSHIP, NUSC_DCN, PP,
                                 with_sparse_backbone)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_sliced(model, test_cfg, n_model):
    """The port names of the parameters JAX's ``param_sharding`` slices
    over ``model=n_model``."""
    from jax.sharding import PartitionSpec as P

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.parallel.mesh import make_mesh, param_sharding
    from partner_tpu_torch.convert import torch_param_name

    jdet = jax_build(model, None, test_cfg)
    ex = {"points": np.zeros((1, 64, 7), np.float32),
          "points_mask": np.zeros((1, 64), bool)}
    if getattr(jdet, "input_kind", "points") == "voxels":
        ex = {"features": np.zeros((1, 64, 5), np.float32),
              "coords": np.zeros((1, 64, 3), np.int32),
              "voxel_mask": np.zeros((1, 64), bool)}
    params = jax.eval_shape(functools.partial(jdet.module.init, train=False),
                            jax.random.PRNGKey(0), ex)["params"]
    mesh = make_mesh(1, n_model, 1, devices=jax.devices("cpu")[:n_model])
    out = set()
    for path, sh in jax.tree_util.tree_flatten_with_path(
            param_sharding(params, mesh))[0]:
        if sh.spec != P():
            keys = tuple(k.key for k in path)
            leaf = functools.reduce(lambda t, k: t[k], keys, params)
            out.add(torch_param_name(keys, len(leaf.shape)))
    return out


@pytest.mark.parametrize("config,n_model", [
    (FLAGSHIP, 2), (FLAGSHIP, 4), (CENTERPOINT, 2), (PP, 2), (NUSC_DCN, 2),
    ("sparse", 2)])
def test_placement_is_jax_param_sharding_at_full_width(config, n_model):
    """The port's model-sliced tensors are JAX's at full width: the
    flagship (model 2 and 4), CenterPoint, PointPillars, nuScenes DCN (its
    raw ``deform_kernel`` keeps flax's layout) and the flagship on the
    sparse backbone (``SparseConv_k`` kernels keep it too). Prints the
    counts and, for the flagship, which of the Swin blocks' weights (read
    gathered by the whole-block kernel) the rule picks."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.parallel import tp
    from partner_tpu_torch.utils.config import load_config

    path = FLAGSHIP if config == "sparse" else config
    cfg = load_config(os.path.join(ROOT, path))
    model = cfg["model"]
    if config == "sparse":
        model = with_sparse_backbone(model)
    want = _jax_sliced(model, cfg["test_cfg"], n_model)
    det = build_detector(model, None, cfg["test_cfg"], device="meta")
    dims = tp.placement(det.module, n_model)
    params = dict(det.module.named_parameters())
    print(f"{config} model={n_model}: {len(dims)} of {len(params)} "
          f"parameters sliced (JAX {len(want)})")
    if config == FLAGSHIP:
        print("  Swin block weights sliced:", sorted(
            n for n in dims if ".layer.block" in n))
    assert set(dims) == want and want
    for name, dim in dims.items():   # the dim holds the output channels
        assert params[name].shape[dim] % n_model == 0, name
        if ".ConvTranspose_" in name:
            assert dim == 1, name


def test_rank_order_is_jax_device_order():
    """Rank ``(d * M + m) * K + a`` sits at (d, m, a), as ``make_mesh``
    reshapes the device list to (data, model, azimuth)."""
    from partner_tpu_torch.parallel.mesh import Mesh, rank_of

    for shape in ((2, 2, 2), (1, 2, 4), (4, 1, 2), (3, 2, 1)):
        grid = np.arange(int(np.prod(shape))).reshape(shape)
        for rank in range(grid.size):
            coords = Mesh(*shape, rank=rank).coords
            assert grid[coords] == rank == rank_of(*coords, shape)


def test_check_runs_what_jax_runs_and_stops_the_rest():
    """``mesh.check`` returns the axes of every mesh JAX's CLIs run on the
    port's detectors: K = 2 and 4 on the flagship, Waymo CenterPoint (256
    rows at neck stride 2) and nuScenes DCN (128); the model axis on any
    detector. It stops, naming the cause, on a mesh that is not the
    world's, a batch the data axis does not divide, the azimuth axis on a
    detector whose JAX builder takes no ``bev_pspec``, and rows that do
    not split into runs of whole neck strides."""
    from partner_tpu_torch.parallel.mesh import azimuth_rows, check
    from partner_tpu_torch.utils.config import load_config

    models = {k: load_config(os.path.join(ROOT, p))["model"] for k, p in
              (("flagship", FLAGSHIP), ("cp", CENTERPOINT), ("dcn", NUSC_DCN),
               ("pp", PP))}
    assert azimuth_rows(models["flagship"]) == azimuth_rows(
        models["cp"]) == (256, 2)
    assert azimuth_rows(models["dcn"]) == (128, 2)
    for k in ("flagship", "cp", "dcn"):
        for n_az in (2, 4):
            assert check(f"azimuth={n_az}", n_az, "t", 4, models[k]) == (
                1, 1, n_az)
        assert check("data=2,model=2,azimuth=2", 8, "t", 2, models[k]) == (
            2, 2, 2)
    assert check("model=2", 2, "t", 1, models["pp"]) == (1, 2, 1)
    assert check(None, 3, "t", 3) == (3, 1, 1)
    for spec, world, batch, model, says in (
            ("data=2", 1, 2, "flagship", "2 processes, but 1 run"),
            ("data=1,model=2", 4, 4, "flagship", "2 processes, but 4 run"),
            ("data=2,model=2", 4, 3, "flagship", "batch_size 3 not "
                                                 "divisible by mesh data=2"),
            ("azimuth=2", 2, 2, "pp", "detector PointPillars takes no "
                                      "bev_pspec"),
            ("azimuth=3", 3, 3, "flagship", "256 azimuth rows do not split "
                                            "into 3 runs"),
            ("azimuth=256", 256, 2, "flagship",
             r"do not split into 256 runs of whole neck strides \(2\)"),
            ("batch=2", 2, 2, "flagship", "unknown mesh axis")):
        with pytest.raises(SystemExit, match=says):
            check(spec, world, "train", batch, models[model])
