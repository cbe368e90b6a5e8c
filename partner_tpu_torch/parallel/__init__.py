"""Data parallelism of the port over ``torch.distributed`` (counterpart of
``partner_tpu/parallel/``): :mod:`.dist` (process group, collectives that
carry autograd, the eval gather), :mod:`.mesh` (the ``--mesh`` spec) and
:mod:`.halo` (the azimuth ring halo)."""

from . import dist  # noqa: F401
