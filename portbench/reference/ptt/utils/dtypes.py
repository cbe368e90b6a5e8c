"""Compute-dtype resolution.

Counterpart of ``partner_tpu/utils/dtypes.py``. The JAX side downgrades
bf16 to f32 on its CPU backend because XLA:CPU cannot run bf16 dots; torch
can, so names resolve as written here. The CPU parity tests build both
sides in float32.
"""

import torch

_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_compute_dtype(dt):
    """torch.dtype for a config name ("bfloat16") or a torch.dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _NAMES[str(dt)]
    except KeyError:
        raise ValueError(f"unknown compute dtype {dt!r}") from None
