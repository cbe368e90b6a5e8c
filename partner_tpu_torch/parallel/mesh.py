"""The ``(data, model, azimuth)`` mesh of torchrun's ranks (counterpart of
``partner_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model, azimuth)`` mesh
in device order (``make_mesh``); the port lays out torchrun's ranks the
same way, one process a mesh position: rank ``(d * M + m) * K + a`` sits
at data ``d``, model ``m``, azimuth ``a`` of a ``data=D,model=M,azimuth=K``
mesh. :func:`build` makes the groups of every axis, every rank together in
one fixed order:

- ``data``: the ranks of one ``(m, a)``, each holding its part of every
  global batch; the batch statistics and loss normalizers reduce over it;
- ``model``: the ranks of one ``(d, a)``, which hold the same batch and
  compute the same values; each holds a slice of the large kernels
  (``parallel.tp``) and all-gathers them where they are used;
- ``azimuth``: the ranks of one ``(d, m)``, in ring order; each runs the
  neck of ``VoxelNetV3`` and ``VoxelNet`` on its contiguous run of the
  BEV map's azimuth rows (``parallel.halo``);
- ``grad``: the ranks of one ``m`` (data x azimuth), over which the
  gradients are summed; ``neck``: the same ranks, apart, for the neck's
  BatchNorm statistics;
- ``replica``: the ranks of one ``d`` (model x azimuth), which compute on
  one batch: its rank at model 0, azimuth 0 loads it and broadcasts it
  to the others (:func:`batches`; a loader's threads finish batches and
  draw from its random state in an order no two processes share).

:func:`check` stops a CLI on a spec it cannot run, naming the cause;
:func:`place` puts a detector on the mesh.
"""

import math
import sys

import numpy as np
import torch.distributed as tdist

# the detectors whose neck the azimuth axis shards: the only builders of
# the JAX package that take ``bev_pspec`` (``detectors.py:413-415, 493-495``)
AZIMUTH_DETECTORS = ("VoxelNetV3", "VoxelNet")
_current = {"mesh": None}


def parse_mesh_spec(spec, n_devices):
    """Parse a CLI mesh spec "data=4,model=2,azimuth=1" -> (nd, nm, na).

    Unnamed axes default to 1; spec None or "auto" puts every device on
    the data axis; a spec without ``data`` gives it what the other axes
    leave. An unknown axis raises ValueError."""
    if spec in (None, "", "auto"):
        return n_devices, 1, 1
    sizes = {"data": None, "model": 1, "azimuth": 1}
    for part in str(spec).split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in sizes:
            raise ValueError(f"unknown mesh axis {k!r} (data/model/azimuth)")
        sizes[k] = int(v)
    if sizes["data"] is None:
        sizes["data"] = max(1, n_devices // (sizes["model"] * sizes["azimuth"]))
    return sizes["data"], sizes["model"], sizes["azimuth"]


def azimuth_rows(model_cfg):
    """A VoxelNet / VoxelNetV3 model cfg -> (the BEV map's azimuth rows,
    the neck's total downsampling stride)."""
    head = model_cfg.get("bbox_head") or model_cfg.get("seg_head")
    vg = head["voxel_generator"]
    pr, vs = vg["range"], vg["voxel_size"]
    n_az = int(round((pr[4] - pr[1]) / vs[1]))
    stride = math.prod(model_cfg["neck"].get("ds_layer_strides", (1,)))
    return n_az // head.get("out_size_factor", 8), int(stride)


def check(spec, world, tool, batch_size=None, model_cfg=None):
    """``--mesh`` of the CLI ``tool`` over ``world`` processes ->
    (data, model, azimuth); stops the run with a message naming the cause
    where the azimuth axis is asked of a detector whose neck it cannot
    shard or of a map whose rows do not split into runs of whole neck
    strides, the mesh is not that of the processes running, or the global
    batch does not split over ``data``."""
    try:
        n_data, n_model, n_az = parse_mesh_spec(spec, world)
    except ValueError as e:
        sys.exit(f"{tool}: --mesh {spec!r}: {e}")
    if n_az > 1 and model_cfg is not None:
        kind = model_cfg.get("type")
        if kind not in AZIMUTH_DETECTORS:
            sys.exit(f"{tool}: --mesh {spec!r}: azimuth={n_az} shards the "
                     f"neck of {' and '.join(AZIMUTH_DETECTORS)}; the "
                     f"detector {kind} takes no bev_pspec in the JAX package")
        neck = dict(model_cfg.get("neck") or {}).get("type")
        if neck != "RPN":
            sys.exit(f"{tool}: --mesh {spec!r}: azimuth={n_az} shards an RPN "
                     f"neck (its halo); {kind}'s neck is {neck}")
        rows, stride = azimuth_rows(model_cfg)
        if rows % n_az or (rows // n_az) % stride:
            sys.exit(f"{tool}: --mesh {spec!r}: the BEV map's {rows} "
                     f"azimuth rows do not split into {n_az} runs of whole "
                     f"neck strides ({stride}); the port does not pad "
                     "uneven shards (ROADMAP.md section 3)")
    if n_data * n_model * n_az != world:
        sys.exit(f"{tool}: --mesh {spec!r} asks for data={n_data}, "
                 f"model={n_model}, azimuth={n_az}: "
                 f"{n_data * n_model * n_az} processes, but {world} run; "
                 f"launch it with torchrun --nproc_per_node "
                 f"{n_data * n_model * n_az}")
    if batch_size is not None and batch_size % n_data:
        sys.exit(f"{tool}: batch_size {batch_size} not divisible by mesh "
                 f"data={n_data}")
    return n_data, n_model, n_az


class Mesh:
    """This rank's place on a ``data x model x azimuth`` mesh and the
    process groups of its axes (None where no process group exists)."""

    def __init__(self, n_data=1, n_model=1, n_az=1, rank=0):
        self.shape = (n_data, n_model, n_az)
        self.rank = rank
        a = rank % n_az
        m = (rank // n_az) % n_model
        self.coords = (rank // (n_az * n_model), m, a)
        self.data = self.model = self.azimuth = self.grad = None
        self.neck = self.replica = None

    @property
    def n_data(self):
        return self.shape[0]

    @property
    def n_model(self):
        return self.shape[1]

    @property
    def n_az(self):
        return self.shape[2]

    def __repr__(self):
        d, m, a = self.coords
        return (f"Mesh(data={self.n_data}, model={self.n_model}, "
                f"azimuth={self.n_az}; rank {self.rank} at d={d}, m={m}, "
                f"a={a})")


def rank_of(d, m, a, shape):
    """The rank at mesh position (d, m, a): JAX's device order."""
    _, n_model, n_az = shape
    return (d * n_model + m) * n_az + a


def build(n_data=None, n_model=1, n_az=1):
    """The mesh of the running group (``data`` defaults to what the other
    axes leave), made current. Every rank must call it, at the same point:
    each group is made by every rank together (``new_group``), in one
    fixed order. Without a process group: a mesh of one, no groups."""
    if not tdist.is_initialized():
        if (n_data or 1) * n_model * n_az != 1:
            raise ValueError("a mesh of more than one rank needs a process "
                             "group (torchrun)")
        return set_current(Mesh())
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if n_data is None:
        n_data = world // (n_model * n_az)
    shape = (n_data, n_model, n_az)
    if n_data * n_model * n_az != world:
        raise ValueError(f"mesh {shape} is not the world of {world}")
    mesh = Mesh(*shape, rank=rank)
    grid = np.arange(world).reshape(shape)   # JAX's device order
    per_m = grid.transpose(1, 0, 2).reshape(n_model, -1)   # data x azimuth
    axes = (("data", grid.transpose(1, 2, 0).reshape(-1, n_data)),
            ("model", grid.transpose(0, 2, 1).reshape(-1, n_model)),
            ("azimuth", grid.reshape(-1, n_az)),
            ("grad", per_m), ("neck", per_m),
            ("replica", grid.reshape(n_data, -1)))
    for name, lists in axes:
        for ranks in lists.tolist():
            group = tdist.new_group(ranks)
            if rank in ranks:
                setattr(mesh, name, group)
    return set_current(mesh)


def set_current(mesh):
    """Make ``mesh`` (or None) the one :func:`current` returns."""
    _current["mesh"] = mesh
    return mesh


def current():
    """The current mesh; with none built, a data-only mesh of the running
    group (made now: every rank must get here together), or a mesh of one
    without a group."""
    if _current["mesh"] is None:
        build()
    return _current["mesh"]


def batches(loader, mesh=None):
    """``loader``'s batches, the same on every rank of this data
    coordinate: its rank at model 0, azimuth 0 iterates ``loader`` and
    broadcasts each batch over the ``replica`` group to the other model
    and azimuth ranks, whose own loaders stay idle; ``loader`` itself on a
    data-only mesh. Every rank of the coordinate must take the same number
    of batches (a loop that stops early stops alike on each)."""
    from . import dist

    mesh = mesh or current()
    if mesh.n_model * mesh.n_az == 1:
        yield from loader
        return
    src = rank_of(mesh.coords[0], 0, 0, mesh.shape)
    if mesh.rank == src:
        for batch in loader:
            dist.broadcast_object(batch, src, mesh.replica)
            yield batch
        dist.broadcast_object(None, src, mesh.replica)
        return
    while True:
        batch = dist.broadcast_object(None, src, mesh.replica)
        if batch is None:
            return
        yield batch


def place(det, mesh=None):
    """Put a detector on ``mesh`` (the current one by default), after its
    weights are loaded: its large kernels sliced over ``model``
    (``parallel.tp.shard_module``) and, on an azimuth axis, its neck set
    to run on this rank's azimuth rows (``VoxelNetModule.azimuth``).
    Returns the names of the sliced parameters."""
    from . import halo, tp

    mesh = mesh or current()
    names = tp.shard_module(det.module, mesh)
    if mesh.n_az > 1:
        det.module.azimuth = halo.AzimuthShard(mesh.azimuth, mesh.neck)
    return names
