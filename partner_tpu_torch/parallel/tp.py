"""The mesh's ``model`` axis: JAX's tensor-parallel placement
(counterpart of ``place_train_state``, ``_tp_shape_rule`` and
``param_sharding``, ``partner_tpu/parallel/mesh.py:93-143``).

The placement is JAX's. A parameter is sliced over the ``model`` ranks
where its flax leaf has at least 2 dims and 2**16 elements and a last
(output-channel) dim that the model axis divides; everything else is
replicated. The rule reads the flax leaf's shape through
``convert.flax_leaf`` (a rule read off the port's own shapes would pick
other tensors: a transposed conv keeps its output channels in dim 1), and
the slice is taken along the port dim that holds that last flax dim. Each
model rank holds only its slice, and the optimizer built on the module
afterwards holds only that slice's Adam slots.

The compute is replicated across the model ranks. Each use of a sliced
parameter all-gathers its slices over the ``model`` group (the module's
attribute is a property that gathers), so every module, the hand kernels
included, sees the whole weight; the gather's backward keeps this rank's
slice of the gradient, which is equal on every model rank: they hold the
same batch and compute the same values. Splitting the products' columns
across the ranks is later work.

A sliced parameter carries ``model_shard`` (:class:`Shard`). Checkpoints
stay in the data-only layout: :func:`full_state_dict` gathers the slices,
:func:`load_state_dict` takes this rank's slice of a whole tensor.
"""

import collections
import math

import torch

from ..convert import flax_leaf
from . import dist

MIN_SIZE = 2 ** 16   # JAX's ``min_size``

Shard = collections.namedtuple("Shard", "dim parts index group")


def placement(module, n_model):
    """{parameter name: the port dim JAX's rule slices} over ``n_model``
    model ranks; {} on a model axis of one."""
    out = {}
    if n_model <= 1:
        return out
    for name, p in module.named_parameters():
        _, fshape, dim = flax_leaf(name, tuple(p.shape))
        if (len(fshape) >= 2 and math.prod(fshape) >= MIN_SIZE
                and fshape[-1] % n_model == 0):
            out[name] = dim
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, shard):
        ctx.shard = shard
        return torch.cat(dist.all_gather(piece, shard.group), shard.dim)

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        n = g.shape[s.dim] // s.parts
        return g.narrow(s.dim, s.index * n, n).contiguous(), None


def gathered(p):
    """The whole tensor of a sliced parameter (autograd: this rank's slice
    of the cotangent)."""
    return _Gather.apply(p, p.model_shard)


def _gathering_class(mod):
    """``mod``'s class, made once into a subclass of its own in which
    each sliced parameter's attribute gathers."""
    cls = type(mod)
    if "_gathering" not in cls.__dict__:
        cls = type(cls.__name__, (cls,), {"_gathering": True})
        mod.__class__ = cls
    return cls


def shard_module(module, mesh):
    """Slice ``module``'s parameters over ``mesh``'s model axis by
    :func:`placement` -> the names of the sliced parameters (sorted)."""
    dims = placement(module, mesh.n_model)
    index = mesh.coords[1]
    for name, dim in dims.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        p = mod._parameters[leaf]
        n = p.shape[dim] // mesh.n_model
        piece = torch.nn.Parameter(
            p.detach().narrow(dim, index * n, n).clone(),
            requires_grad=p.requires_grad)
        piece.model_shard = Shard(dim, mesh.n_model, index, mesh.model)
        mod._parameters[leaf] = piece
        cls = _gathering_class(mod)
        setattr(cls, leaf, property(
            lambda self, leaf=leaf: gathered(self._parameters[leaf])))
    return sorted(dims)


def is_sliced(p):
    return getattr(p, "model_shard", None) is not None


def local_slice(p, whole):
    """This rank's slice of ``whole`` for the sliced parameter ``p``
    (``whole`` itself for a replicated one)."""
    if not is_sliced(p):
        return whole
    s = p.model_shard
    n = whole.shape[s.dim] // s.parts
    return whole.narrow(s.dim, s.index * n, n)


def whole(p, t):
    """``t`` (a tensor of ``p``'s slice shape, such as its Adam slot) with
    every model rank's slice gathered; ``t`` itself for a replicated
    ``p``. Every model rank must call it."""
    if not is_sliced(p):
        return t
    return torch.cat(dist.all_gather(t, p.model_shard.group),
                     p.model_shard.dim)


@torch.no_grad()
def full_state_dict(module):
    """``module.state_dict()`` in the data-only layout: every sliced
    parameter gathered. Every model rank must call it."""
    sd = module.state_dict()
    for name, p in module.named_parameters():
        if is_sliced(p):
            sd[name] = whole(p, p.detach())
    return sd


def load_state_dict(module, state_dict, strict=True):
    """Load a data-only-layout ``state_dict``: each sliced parameter takes
    this rank's slice of its whole tensor."""
    params = dict(module.named_parameters())
    return module.load_state_dict(
        {k: local_slice(params[k], v) if k in params else v
         for k, v in state_dict.items()}, strict=strict)
