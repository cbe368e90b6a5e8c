"""The mesh of the port over ``torch.distributed`` (counterpart of
``partner_tpu/parallel/``): :mod:`.dist` (process group, collectives that
carry autograd, the eval gather), :mod:`.mesh` (the ``--mesh`` spec, the
``(data, model, azimuth)`` layout of the ranks and its groups), :mod:`.tp`
(the model axis's placement) and :mod:`.halo` (the azimuth halos)."""

from . import dist  # noqa: F401
