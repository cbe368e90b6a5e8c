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
- ``models.cswin``'s ``CSWinBlock`` needs no rule of its own: its
  ``qkv``, ``proj``, ``mlp/Dense_k`` and each branch's ``pos_fc1`` /
  ``pos_fc2`` map by the Dense rule, ``norm1``, ``norm2`` and ``pos_ln``
  by the ``scale`` rule.

Inputs are nested dicts of numpy arrays (``{"params": ..., "batch_stats":
...}``), so this module needs neither jax nor flax.
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


def _param(path, arr):
    *mods, leaf = _collapse(path)
    if _keeps_names(mods):
        pass
    elif leaf == "kernel":
        if arr.ndim == 4 and mods and mods[-1].startswith("ConvTranspose"):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"unexpected kernel {'/'.join(path)} {arr.shape}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mods + [leaf]), arr


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
