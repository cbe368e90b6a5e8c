"""flax variables -> torch ``state_dict`` for the port's modules.

The other direction of ``partner_tpu/train/torch_convert.py``. The port's
submodules carry flax's names (``Conv_0``, ``BatchNorm_0``,
``block_a2d0``, ...), so one walker maps every leaf by name:

- ``kernel`` of a Conv: HWIO -> OIHW, and DHWIO -> OIDHW for a 3D conv;
  of a Dense: (in, out) -> (out, in); of a ConvTranspose: (kh, kw, I, O)
  flipped spatially -> (I, O, kh, kw), the inverse of
  ``torch_convert.convert_torch_convtranspose2d``;
- ``scale`` -> ``weight``; batch stats ``mean``/``var`` ->
  ``running_mean``/``running_var``;
- the ``layers.BatchNorm`` wrapper's nested ``BatchNorm_k/BatchNorm_0``
  collapses to ``BatchNorm_k``, and a stream neck's
  ``deblock{j}_bn/BatchNorm_0`` and ``block{i}_bn{li}/BatchNorm_0``
  (``RPNHalo``, ``RPNUber``, ``RPNWaymoLSTM``) to ``deblock{j}_bn`` and
  ``block{i}_bn{li}`` (its ``deblock{j}_conv`` maps by the Conv rule, a
  transposed one too: ``models.rpn_stream.DeblockTranspose`` keeps that
  layout; so do ``block{i}_conv{li}`` and the ConvLSTM's
  ``memory/gates``, with its bias);
- flax's ``OptimizedLSTMCell`` (HAN's sector memory ``lstm``) maps by
  the Dense rule: its input kernels ``ii``, ``if``, ``ig``, ``io`` (no
  bias) and recurrent kernels ``hi``, ``hf``, ``hg``, ``ho`` (with the
  bias), gate order i, f, g, o, are ``models.strobe.LSTMCell``'s
  submodules of those names;
- raw parameters keep name and layout: ``stem{i}_kernel/scale/bias``,
  the ``stem{i}_mean/var`` stats, ``tau``, and a DCN head's
  ``deform_kernel`` (K, C, Cout) and ``deform_bias`` (its 1x1
  ``conv_offset``, ``hm_out`` and bare ``BatchNorm_0`` map by the Conv and
  BatchNorm rules);
- the sparse backbone's leaves keep flax's names and layouts: a
  ``SparseConv_k``'s flat (K*Cin, Cout) ``kernel`` and its ``bias``, and a
  ``MaskedBatchNorm_k``'s ``scale``, ``bias``, ``mean`` and ``var``; so do
  a pillar encoder's ``pfn{i}_bn`` (a ``MaskedBatchNorm``), while its
  ``pfn{i}_dense`` kernel maps by the Dense rule;
- a single-group head's raw parameters keep name and layout too:
  ``shared_norm`` (``RSNorm``: ``scale``, ``bias``, each (g, 1, C)) and
  each ``{head}_rs`` (``RangeStratified``: ``kernel`` (g, 3, 3, C, F),
  ``bias``, ``gn_scale``, ``gn_bias``); its ``shared_conv``,
  ``{head}_out``, ``cal_*`` and each ``*_stack/Conv_k`` (grouped convs
  too: HWIO (kh, kw, C / groups, F) -> (F, C / groups, kh, kw)) map by
  the Conv rule, each ``*_stack/GroupNorm_k`` by the ``scale`` rule;
- the factorized 3D trunk's R(2+1)D convs (``PolarDenseFHD(factorized=
  True)``: a stage conv's ``conv_bev`` / ``conv_z``, a residual block's
  ``conv1_bev``, ``conv1_z``, ``conv2_bev``, ``conv2_z``) map by the Conv
  rule, DHWIO -> OIDHW;
- ``models.cswin``'s ``CSWinBlock`` needs no rule of its own: its
  ``qkv``, ``proj``, ``mlp/Dense_k`` and each branch's ``pos_fc1`` /
  ``pos_fc2`` map by the Dense rule, ``norm1``, ``norm2`` and ``pos_ln``
  by the ``scale`` rule.

Inputs are nested dicts of numpy arrays (``{"params": ..., "batch_stats":
...}``), so this module needs neither jax nor flax. :func:`flax_leaf`
reads the layouts backwards (a port parameter -> its flax path and
shape), as the mesh's model axis needs (``parallel.tp``).
"""

import re

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _collapse(path):
    path = list(path)
    if (len(path) >= 3 and path[-2] == "BatchNorm_0"
            and (path[-3].startswith("BatchNorm_")
                 or re.fullmatch(r"deblock\d+_bn|block\d+_bn\d+",
                                 path[-3]))):
        del path[-2]
    return path


def _keeps_names(mods):
    return bool(mods) and (
        mods[-1].startswith(("SparseConv_", "MaskedBatchNorm_"))
        or re.fullmatch(r"pfn\d+_bn|shared_norm|\w+_rs", mods[-1])
        is not None)


def _kernel_layout(mods, ndim):
    """A flax ``kernel`` of rank ``ndim`` under the modules ``mods`` ->
    (the transpose taking it to the port's layout, whether it is flipped
    spatially first)."""
    if ndim == 4 and mods and mods[-1].startswith("ConvTranspose"):
        return (2, 3, 0, 1), True
    perm = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2), 2: (1, 0)}.get(ndim)
    if perm is None:
        raise ValueError(f"unexpected kernel {'/'.join(mods)} of rank {ndim}")
    return perm, False


def _param_layout(path, ndim):
    """A flax parameter's path and rank -> (its port name, the transpose
    to the port's layout or None, whether it is flipped first)."""
    *mods, leaf = _collapse(path)
    perm, flip = None, False
    if _keeps_names(mods):
        pass
    elif leaf == "kernel":
        perm, flip = _kernel_layout(mods, ndim)
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mods + [leaf]), perm, flip


def torch_param_name(path, ndim):
    """A flax parameter's path (a tuple of names) and rank -> the port
    parameter it loads into."""
    return _param_layout(path, ndim)[0]


def _param(path, arr):
    name, perm, flip = _param_layout(path, arr.ndim)
    if flip:
        arr = arr[::-1, ::-1]
    if perm is not None:
        arr = arr.transpose(perm)
    return name, arr


def _stat(path, arr):
    *mods, leaf = _collapse(path)
    if not _keeps_names(mods):
        leaf = _STAT_NAMES.get(leaf, leaf)
    return ".".join(mods + [leaf]), arr


def flax_to_torch(variables):
    """{"params", "batch_stats"} nested numpy dicts -> torch state_dict
    (float32 tensors) for the matching port module."""
    sd = {}
    for col, fn in (("params", _param), ("batch_stats", _stat)):
        for path, arr in _flatten(variables.get(col, {})):
            name, arr = fn(path, arr)
            if name in sd:
                raise KeyError(f"two flax leaves map to {name}")
            sd[name] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def flax_param_path(name, ndim):
    """A port parameter's name and rank -> its flax path ("a/b/kernel"),
    the inverse of the parameter rule above. Exact for every parameter of
    more than one dimension (kernels and raw parameters keep flax's module
    names); a BatchNorm's ``scale`` and ``bias`` come back without the
    wrapper level that :func:`flax_to_torch` collapses
    (``BatchNorm_k/BatchNorm_0``)."""
    *mods, leaf = name.split(".")
    if leaf == "weight" and not _keeps_names(mods):
        leaf = "kernel" if ndim > 1 else "scale"
    return "/".join(mods + [leaf])


def flax_leaf(name, shape):
    """A port parameter's name and shape -> (its flax path, the flax
    leaf's shape, the port dim that holds the flax leaf's last dim): the
    layouts of :func:`flax_to_torch` read backwards. A kernel's output
    channels are dim 0 of a Linear, Conv2d or Conv3d weight and dim 1 of
    a ConvTranspose2d weight; a parameter that keeps flax's name keeps its
    layout."""
    path = flax_param_path(name, len(shape))
    *mods, leaf = path.split("/")
    if leaf != "kernel" or _keeps_names(mods):
        return path, tuple(shape), len(shape) - 1
    perm, _ = _kernel_layout(mods, len(shape))
    fshape = [0] * len(shape)
    for i, axis in enumerate(perm):     # port dim i holds flax axis perm[i]
        fshape[axis] = shape[i]
    return path, tuple(fshape), perm.index(len(shape) - 1)
