"""The ``--mesh`` spec of the CLIs (counterpart of
``partner_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model, azimuth)`` mesh.
The port has the ``data`` axis: one process per card, each holding its
part of every global batch, the whole world on ``data``. The ``model``
axis (the tensor-parallel placement of large kernels,
``partner_tpu/parallel/mesh.py:93-143``) and the ``azimuth`` axis of a
general detector (XLA's spatial partition, ``bev_pspec``) compute what a
data-only mesh computes and are not ported (ROADMAP.md queue 1 item 9a);
a spec that asks for either stops the CLI with a message naming it.
"""

import sys


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


def data_axis(spec, world, tool):
    """Checks ``--mesh`` of the CLI ``tool`` over ``world`` processes:
    stops the run with a message where the spec is not a data-only mesh of
    the world (the data axis is the world)."""
    try:
        n_data, n_model, n_az = parse_mesh_spec(spec, world)
    except ValueError as e:
        sys.exit(f"{tool}: --mesh {spec!r}: {e}")
    if n_model > 1 or n_az > 1:
        sys.exit(f"{tool}: --mesh {spec!r}: the model and azimuth axes "
                 "are not ported; the port runs the data axis, one process "
                 "per card (ROADMAP.md queue 1 item 9a)")
    if n_data != world:
        sys.exit(f"{tool}: --mesh {spec!r} asks for data={n_data}, but "
                 f"{world} process(es) run; launch data=N with torchrun "
                 "--nproc_per_node N")
