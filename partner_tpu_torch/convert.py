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
  collapses to ``BatchNorm_k``;
- raw parameters keep name and layout: ``stem{i}_kernel/scale/bias``,
  the ``stem{i}_mean/var`` stats, and ``tau``.

Inputs are nested dicts of numpy arrays (``{"params": ..., "batch_stats":
...}``), so this module needs neither jax nor flax.
"""

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
            and path[-3].startswith("BatchNorm_")):
        del path[-2]
    return path


def _param(path, arr):
    *mods, leaf = _collapse(path)
    if leaf == "kernel":
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
    return ".".join(mods + [_STAT_NAMES.get(leaf, leaf)]), arr


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
