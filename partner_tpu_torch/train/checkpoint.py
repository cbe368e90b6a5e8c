"""Checkpoints: the port's own format, and a reader of the JAX package's.

The port's format has the layout of ``partner_tpu/train/checkpoint.py``:
step directories ``ckpt_%08d/`` under a work directory, each with a
``state.pt`` payload (``torch.save`` of ``{"step", "state_dict"}``, tensors
on the CPU) and an optional ``meta.json``, and a ``latest`` file naming the
newest step directory, rewritten on every save. Local paths only: the
JAX package's remote stores and model zoo are not ported.

A JAX checkpoint (``state.pkl``, a pickle of host numpy trees) is how
weights trained by the JAX package come across. Its ``opt_state`` holds
optax classes, so a plain ``pickle.load`` would import optax and jax: it
is read by :class:`_NumpyUnpickler`, which lets numpy and plain builtins
through and turns every other class into an inert stub. Of it only
``params`` and ``batch_stats`` are kept, mapped by
:func:`partner_tpu_torch.convert.flax_to_torch`; the Adam state is not.
"""

import json
import os
import pickle
import shutil

import torch

from ..convert import flax_to_torch

PORT_PAYLOAD = "state.pt"
JAX_PAYLOAD = "state.pkl"


def save_checkpoint(work_dir, step, state_dict, meta=None, keep=None):
    """Write ``work_dir/ckpt_{step:08d}/state.pt`` (and ``meta.json``),
    point ``work_dir/latest`` at it, and keep the newest ``keep`` step
    directories when ``keep`` is given. Returns the step directory."""
    name = f"ckpt_{int(step):08d}"
    path = os.path.join(work_dir, name)
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(step),
               "state_dict": {k: v.detach().cpu()
                              for k, v in state_dict.items()}}
    torch.save(payload, os.path.join(path, PORT_PAYLOAD))
    if meta:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    with open(os.path.join(work_dir, "latest"), "w") as f:
        f.write(name)
    if keep:
        ckpts = sorted(d for d in os.listdir(work_dir)
                       if d.startswith("ckpt_"))
        for old in ckpts[:-keep]:
            shutil.rmtree(os.path.join(work_dir, old))
    return path


def latest_checkpoint(work_dir):
    """The step directory ``work_dir/latest`` names, or None."""
    latest = os.path.join(work_dir, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        path = os.path.join(work_dir, f.read().strip())
    return path if _payload_file(path) else None


def _payload_file(step_dir):
    for name in (PORT_PAYLOAD, JAX_PAYLOAD):
        p = os.path.join(step_dir, name)
        if os.path.isfile(p):
            return p
    return None


def load_checkpoint(path):
    """Load a port or a JAX checkpoint -> (payload, meta).

    ``path`` is a step directory, a ``latest`` pointer file, or a payload
    file (``state.pt``, or a JAX ``state.pkl``). ``payload`` is
    ``{"step", "state_dict"}``, the state_dict ready for the port's
    detector module; ``meta`` the step's ``meta.json`` or None."""
    if os.path.isfile(path) and os.path.basename(path) == "latest":
        with open(path) as f:
            name = f.read().strip()
        return load_checkpoint(os.path.join(os.path.dirname(path), name))
    if os.path.isdir(path):
        payload_path = _payload_file(path)
        if payload_path is None:
            raise FileNotFoundError(
                f"{path} holds neither {PORT_PAYLOAD} nor {JAX_PAYLOAD}")
    elif os.path.isfile(path):
        payload_path = path
    else:
        raise FileNotFoundError(path)
    if payload_path.endswith(".pkl"):
        payload = _read_jax_payload(payload_path)
    else:
        payload = torch.load(payload_path, map_location="cpu",
                             weights_only=True)
    meta_path = os.path.join(os.path.dirname(payload_path), "meta.json")
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return payload, meta


class _Stub:
    """Stands in for a class of the JAX stack (an optax state, ...): takes
    any constructor arguments and state, and keeps them inert."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray"}


class _NumpyUnpickler(pickle.Unpickler):
    """Lets numpy and plain builtin types through; every other class
    becomes a :class:`_Stub` subclass of its name, so nothing is imported."""

    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module in ("builtins", "collections") and (
                name in _BUILTINS or name == "OrderedDict"):
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": module})


def _read_jax_payload(path):
    """A JAX ``state.pkl`` -> {"step", "state_dict"} (params and
    batch_stats converted; the optimizer state dropped)."""
    with open(path, "rb") as f:
        raw = _NumpyUnpickler(f).load()
    variables = {"params": raw["params"],
                 "batch_stats": raw.get("batch_stats") or {}}
    return {"step": int(raw.get("step", 0)),
            "state_dict": flax_to_torch(variables)}
