"""Checkpoints: the port's own format, and a reader of the JAX package's.

The port's format has the layout of ``partner_tpu/train/checkpoint.py``:
step directories ``ckpt_%08d/`` under a work directory, each with a
``state.pt`` payload and an optional ``meta.json``, and a ``latest`` file
naming the newest step directory, rewritten on every save. The payload is
a ``torch.save`` of ``{"step", "state_dict", "opt_state"}``, tensors on the
CPU: ``opt_state`` holds the Adam step count and both moments, keyed by
parameter name (:func:`optimizer_state`). A payload without it (weights
only, as the port's first checkpoints were) still loads for evaluation.
Local paths only: the JAX package's remote stores and model zoo are not
ported.

A JAX checkpoint (``state.pkl``, a pickle of host numpy trees) is how
weights and optimizer state trained by the JAX package come across. Its
``opt_state`` holds optax classes, so a plain ``pickle.load`` would import
optax and jax: it is read by :class:`_NumpyUnpickler`, which lets numpy
and plain builtins through and turns every other class into an inert stub
that keeps its constructor arguments (a named tuple's fields). ``params``
and ``batch_stats`` are mapped by
:func:`partner_tpu_torch.convert.flax_to_torch`, and so are the Adam
moments of the ``ScaleByAdamState`` inside the optax chain (they have the
parameters' layout and names), with its count.
"""

import json
import os
import pickle
import shutil

import torch

from ..convert import flax_to_torch

PORT_PAYLOAD = "state.pt"
JAX_PAYLOAD = "state.pkl"


def _cpu(tensors):
    return {k: v.detach().cpu() for k, v in tensors.items()}


def optimizer_state(module, opt):
    """A ``OneCycleAdam`` on ``module.parameters()`` -> {"count", "mu",
    "nu"}, the moments keyed by parameter name."""
    names = [n for n, _ in module.named_parameters()]
    state = opt.state_dict()
    return {"count": state["count"],
            "mu": dict(zip(names, state["mu"])),
            "nu": dict(zip(names, state["nu"]))}


def restore_train_state(det, opt, payload):
    """Load a payload's weights and BatchNorm statistics into ``det`` and
    its optimizer state into ``opt`` (a ``OneCycleAdam`` on
    ``det.module.parameters()``) -> the payload's step. The counterpart of
    the JAX package's ``restore_train_state``: every part must be there."""
    det.module.load_state_dict(payload["state_dict"], strict=True)
    if "opt_state" not in payload:
        raise KeyError("the checkpoint holds no optimizer state")
    st = payload["opt_state"]
    names = [n for n, _ in det.module.named_parameters()]
    for key in ("mu", "nu"):
        if sorted(st[key]) != sorted(names):
            raise KeyError(f"optimizer {key}: names differ from the module's")
    opt.load_state_dict({"count": st["count"],
                         "mu": [st["mu"][n] for n in names],
                         "nu": [st["nu"][n] for n in names]})
    return int(payload["step"])


def save_checkpoint(work_dir, step, state_dict, meta=None, keep=None,
                    opt_state=None):
    """Write ``work_dir/ckpt_{step:08d}/state.pt`` (and ``meta.json``),
    point ``work_dir/latest`` at it, and keep the newest ``keep`` step
    directories when ``keep`` is given. ``opt_state`` is
    :func:`optimizer_state`'s dict, kept when given. Returns the step
    directory."""
    name = f"ckpt_{int(step):08d}"
    path = os.path.join(work_dir, name)
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(step), "state_dict": _cpu(state_dict)}
    if opt_state is not None:
        payload["opt_state"] = {"count": int(opt_state["count"]),
                                "mu": _cpu(opt_state["mu"]),
                                "nu": _cpu(opt_state["nu"])}
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
    detector module, plus ``opt_state`` (:func:`optimizer_state`'s layout)
    where the checkpoint holds the Adam state; ``meta`` the step's
    ``meta.json`` or None."""
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


def _find_stub(tree, name):
    """The first stub of class ``name`` in a tree of stubs, tuples, lists
    and dicts, or None."""
    if isinstance(tree, _Stub):
        if type(tree).__name__ == name:
            return tree
        tree = tree.args
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _find_stub(t, name)
            if found is not None:
                return found
    return None


def _jax_opt_state(opt_state):
    """optax's ``inject_hyperparams`` state (``InjectHyperparamsState`` or,
    in newer optax, ``InjectStatefulHyperparamsState``; the count first)
    around the chain (clip, ``ScaleByAdamState(count, mu, nu)``, decay,
    lr) -> {"count", "mu", "nu"} in the port's names, or None when the
    tree holds no Adam state."""
    adam = _find_stub(opt_state, "ScaleByAdamState")
    if adam is None:
        return None
    count, mu, nu = adam.args
    inject = (_find_stub(opt_state, "InjectStatefulHyperparamsState")
              or _find_stub(opt_state, "InjectHyperparamsState"))
    if inject is not None and int(inject.args[0]) != int(count):
        raise ValueError(f"optax counts differ: schedule {inject.args[0]}, "
                         f"Adam {count}")
    return {"count": int(count),
            "mu": flax_to_torch({"params": mu}),
            "nu": flax_to_torch({"params": nu})}


def _read_jax_payload(path):
    """A JAX ``state.pkl`` -> {"step", "state_dict"[, "opt_state"]}
    (params and batch_stats converted; the Adam count and moments too
    where the pickle holds them)."""
    with open(path, "rb") as f:
        raw = _NumpyUnpickler(f).load()
    variables = {"params": raw["params"],
                 "batch_stats": raw.get("batch_stats") or {}}
    payload = {"step": int(raw.get("step", 0)),
               "state_dict": flax_to_torch(variables)}
    opt_state = _jax_opt_state(raw.get("opt_state"))
    if opt_state is not None:
        payload["opt_state"] = opt_state
    return payload
