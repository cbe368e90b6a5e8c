"""Checkpoints: the port's own format, and a reader of the JAX package's.

The port's format has the layout of ``partner_tpu/train/checkpoint.py``:
step directories ``ckpt_%08d/`` under a work directory, each with a
``state.pt`` payload and an optional ``meta.json``, and a ``latest`` file
naming the newest step directory, rewritten on every save. The payload is
a ``torch.save`` of ``{"step", "state_dict", "opt_state"}``, tensors on the
CPU: ``opt_state`` holds the optimizer's step count and its state slots
(the Adam moments; AMSGrad's max; SGD's trace), keyed by parameter name
(:func:`optimizer_state`). A payload without it (weights
only, as the port's first checkpoints and converted reference checkpoints
are) still loads for evaluation. A payload is always in the data-only
layout: a run on a mesh's model axis writes its slices gathered
(``parallel.tp.full_state_dict``, :func:`optimizer_state`) and each rank
resumes its own slice, so a checkpoint loads under any mesh.

Every read and write goes through :mod:`..utils.remote_io`, so a work
directory or checkpoint may be a local path or a scheme-prefixed path of a
registered store (``memory://...``). :func:`load_checkpoint` also takes
the URIs of :func:`resolve_checkpoint_uri`: ``modelzoo://<name>`` (looked
up in the JSON file ``PARTNER_TPU_MODEL_ZOO`` names, the same file the JAX
package reads) and ``http(s)://`` or ``file://`` URLs (fetched once into
the ``PARTNER_TPU_CACHE`` directory).

A JAX checkpoint (``state.pkl``, a pickle of host numpy trees) is how
weights and optimizer state trained by the JAX package come across. Its
``opt_state`` holds optax classes, so a plain ``pickle.load`` would import
optax and jax: it is read by :class:`_NumpyUnpickler`, which lets numpy
and plain builtins through and turns every other class into an inert stub
that keeps its constructor arguments (a named tuple's fields). ``params``
and ``batch_stats`` are mapped by
:func:`partner_tpu_torch.convert.flax_to_torch`, and so is the state of
the scale inside the optax chain (Adam's or AMSGrad's moments, SGD's
trace: they have the parameters' layout and names), with its count.
"""

import hashlib
import io
import json
import os
import pickle
import urllib.parse
import urllib.request

import numpy as np
import torch

from ..convert import flax_to_torch
from ..parallel import tp
from ..utils import remote_io as rio

PORT_PAYLOAD = "state.pt"
JAX_PAYLOAD = "state.pkl"


def _cpu(tensors):
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _trainable_names(module):
    return [n for n, p in module.named_parameters() if p.requires_grad]


def optimizer_state(module, opt):
    """A ``ChainOptimizer`` on ``module``'s trainable parameters ->
    {"count", <slot>: {name: tensor}, ...}: the
    step count and each slot of its state (the Adam moments ``mu``,
    ``nu``; AMSGrad's ``nu_max`` too; SGD's ``trace``) keyed by parameter
    name, in the data-only layout: the slots of a parameter sliced over a
    mesh's model axis are gathered (every model rank must call it)."""
    names = _trainable_names(module)
    state = opt.state_dict()
    return dict({"count": state["count"]},
                **{k: {n: tp.whole(p, t) for n, p, t in
                       zip(names, opt.params, v)}
                   for k, v in state.items() if k != "count"})


def restore_train_state(det, opt, payload):
    """Load a payload's weights and BatchNorm statistics into ``det`` and
    its optimizer state into ``opt`` (an optimizer on ``det.module``'s
    trainable parameters) -> the payload's step. The counterpart of the
    JAX package's ``restore_train_state``: every part must be there, and
    the checkpoint's slots must be the optimizer's (a checkpoint of
    another optimizer type raises). On a mesh's model axis each sliced
    parameter and its slots take this rank's slice of the checkpoint's
    whole tensors. Slots of frozen parameters (a JAX
    checkpoint of a frozen two-stage holds them) are left out; any other
    name that differs raises."""
    tp.load_state_dict(det.module, payload["state_dict"], strict=True)
    if "opt_state" not in payload:
        raise KeyError("the checkpoint holds no optimizer state")
    st = payload["opt_state"]
    names = _trainable_names(det.module)
    frozen = {n for n, p in det.module.named_parameters()
              if not p.requires_grad}
    slots = [k for k in st if k != "count"]
    for key in slots:
        if set(names) - set(st[key]) or set(st[key]) - set(names) - frozen:
            raise KeyError(f"optimizer {key}: names differ from the module's")
    opt.load_state_dict(dict({"count": st["count"]}, **{
        k: [tp.local_slice(p, st[k][n]) for n, p in zip(names, opt.params)]
        for k in slots}))
    return int(payload["step"])


def _join(base, *parts):
    return "/".join([base.rstrip("/")] + list(parts))


def save_checkpoint(work_dir, step, state_dict, meta=None, keep=None,
                    opt_state=None):
    """Write ``work_dir/ckpt_{step:08d}/state.pt`` (and ``meta.json``),
    point ``work_dir/latest`` at it, and keep the newest ``keep`` step
    directories when ``keep`` is given. ``opt_state`` is
    :func:`optimizer_state`'s dict, kept when given. ``work_dir`` is a
    local or a remote path. Returns the step directory."""
    name = f"ckpt_{int(step):08d}"
    path = _join(work_dir, name)
    rio.makedirs(path)
    payload = {"step": int(step), "state_dict": _cpu(state_dict)}
    if opt_state is not None:
        payload["opt_state"] = dict(
            {"count": int(opt_state["count"])},
            **{k: _cpu(v) for k, v in opt_state.items() if k != "count"})
    buf = io.BytesIO()
    torch.save(payload, buf)
    rio.write_bytes(_join(path, PORT_PAYLOAD), buf.getvalue())
    if meta:
        rio.write_bytes(_join(path, "meta.json"), json.dumps(meta).encode())
    rio.write_bytes(_join(work_dir, "latest"), name.encode())
    if keep:
        ckpts = sorted(d for d in rio.listdir(work_dir)
                       if d.startswith("ckpt_"))
        for old in ckpts[:-keep]:
            rio.delete_tree(_join(work_dir, old))
    return path


def latest_checkpoint(work_dir):
    """The step directory ``work_dir/latest`` names, or None."""
    latest = _join(work_dir, "latest")
    if not rio.exists(latest):
        return None
    path = _join(work_dir, rio.read_bytes(latest).decode().strip())
    return path if _payload_file(path) else None


def _payload_file(step_dir):
    for name in (PORT_PAYLOAD, JAX_PAYLOAD):
        p = _join(step_dir, name)
        if rio.exists(p):
            return p
    return None


def _model_zoo():
    """``modelzoo://<name>`` -> URI table: the JSON file (``{name: uri}``)
    that ``PARTNER_TPU_MODEL_ZOO`` names (default
    ``~/.cache/partner_tpu/model_zoo.json``), or {} where there is none."""
    zoo_path = os.environ.get(
        "PARTNER_TPU_MODEL_ZOO",
        os.path.expanduser("~/.cache/partner_tpu/model_zoo.json"))
    if not os.path.exists(zoo_path):
        return {}
    with open(zoo_path) as f:
        return json.load(f)


def _download_cached(url):
    """Fetch a checkpoint URL into the ``PARTNER_TPU_CACHE`` directory
    (default ``~/.cache/partner_tpu/checkpoints``) once -> the local file.
    The file is written under a per-process name and renamed into place,
    so processes sharing the cache never read a partial file."""
    cache_dir = os.environ.get(
        "PARTNER_TPU_CACHE",
        os.path.expanduser("~/.cache/partner_tpu/checkpoints"))
    os.makedirs(cache_dir, exist_ok=True)
    base = os.path.basename(urllib.parse.urlparse(url).path) or "ckpt.pkl"
    dest = os.path.join(
        cache_dir, hashlib.sha1(url.encode()).hexdigest()[:16] + "_" + base)
    if not os.path.exists(dest):
        tmp = f"{dest}.part.{os.getpid()}"
        try:
            urllib.request.urlretrieve(url, tmp)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return dest


def resolve_checkpoint_uri(path):
    """``modelzoo://name`` -> its registered URI; ``http(s)://`` and
    ``file://`` URLs -> the cached local file; any other path as it is."""
    if path.startswith("modelzoo://"):
        name = path[len("modelzoo://"):]
        zoo = _model_zoo()
        if name not in zoo:
            raise KeyError(f"model zoo has no entry {name!r} (registry: the "
                           "PARTNER_TPU_MODEL_ZOO json)")
        path = zoo[name]
    if path.startswith(("http://", "https://", "file://")):
        return _download_cached(path)
    return path


def load_checkpoint(path):
    """Load a port or a JAX checkpoint -> (payload, meta).

    ``path`` is a step directory, a ``latest`` pointer file, or a payload
    file (``state.pt``, or a JAX ``state.pkl``), local or remote, or a URI
    of :func:`resolve_checkpoint_uri`. ``payload`` is ``{"step",
    "state_dict"}``, the state_dict ready for the port's detector module,
    plus ``opt_state`` (:func:`optimizer_state`'s layout) where the
    checkpoint holds the Adam state; ``meta`` the step's ``meta.json`` or
    None."""
    path = resolve_checkpoint_uri(path)
    if os.path.basename(path) == "latest" and rio.exists(path):
        name = rio.read_bytes(path).decode().strip()
        return load_checkpoint(_join(os.path.dirname(path), name))
    payload_path = _payload_file(path)
    if payload_path is None:
        if os.path.isdir(path):
            raise FileNotFoundError(
                f"{path} holds neither {PORT_PAYLOAD} nor {JAX_PAYLOAD}")
        if not rio.exists(path):
            raise FileNotFoundError(path)
        payload_path = path
    data = rio.read_bytes(payload_path)
    if payload_path.endswith(".pkl"):
        payload = _read_jax_payload(data)
    else:
        payload = torch.load(io.BytesIO(data), map_location="cpu",
                             weights_only=True)
    meta_path = _join(os.path.dirname(payload_path), "meta.json")
    meta = None
    if rio.exists(meta_path):
        meta = json.loads(rio.read_bytes(meta_path).decode())
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
    around the chain (clip, the scale's state, decay, lr) -> {"count",
    <slot>: {name: tensor}} in the port's names, or None when the tree
    holds no scale state. The scale's state is ``ScaleByAdamState(count,
    mu, nu)``, ``ScaleByAmsgradState(count, mu, nu, nu_max)`` or
    ``TraceState(trace)`` (whose count is the schedule's)."""
    inject = (_find_stub(opt_state, "InjectStatefulHyperparamsState")
              or _find_stub(opt_state, "InjectHyperparamsState"))
    found = None
    for cls, slots in (("ScaleByAdamState", ("mu", "nu")),
                       ("ScaleByAmsgradState", ("mu", "nu", "nu_max")),
                       ("TraceState", ("trace",))):
        st = _find_stub(opt_state, cls)
        if st is not None:
            found = (cls, slots, st)
            break
    if found is None:
        return None
    cls, slots, st = found
    if cls == "TraceState":
        if inject is None:
            return None
        count, trees = int(inject.args[0]), st.args
    else:
        count, trees = int(st.args[0]), st.args[1:]
        if inject is not None and int(inject.args[0]) != count:
            raise ValueError(f"optax counts differ: schedule "
                             f"{inject.args[0]}, {cls} {count}")
    return dict({"count": count},
                **{k: flax_to_torch({"params": t})
                   for k, t in zip(slots, trees)})


def _read_jax_payload(data):
    """A JAX ``state.pkl``'s bytes -> {"step", "state_dict"[,
    "opt_state"]} (params and batch_stats converted; the Adam count and
    moments too where the pickle holds them)."""
    raw = _NumpyUnpickler(io.BytesIO(data)).load()
    variables = {"params": raw["params"],
                 "batch_stats": raw.get("batch_stats") or {}}
    payload = {"step": int(raw.get("step", 0)),
               "state_dict": flax_to_torch(variables)}
    opt_state = _jax_opt_state(raw.get("opt_state"))
    if opt_state is not None:
        payload["opt_state"] = opt_state
    return payload


# ---------------------------------------------------------------------------
# reference (torch) weight layouts -> the flax layouts, as
# ``partner_tpu/train/checkpoint.py:189-209`` has them; numpy in and out
# ---------------------------------------------------------------------------


def convert_torch_conv2d(w):
    """(O, I, kh, kw) -> flax (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def convert_torch_linear(w):
    """(O, I) -> flax (I, O)."""
    return np.transpose(w, (1, 0))


def convert_torch_subm_conv(w):
    """spconv SubMConv3d / SparseConv3d weight, (O, kz, ky, kx, I) or
    (kz, ky, kx, I, O) -> the flat (K*I, O) kernel of
    ``models.sparse.SparseConv`` (z, y, x kernel-major, then input
    channel). The layout is told as in JAX: (kz, ky, kx, I, O) when
    ``shape[0] < shape[-1]``, else (O, kz, ky, kx, I)."""
    w = np.asarray(w)
    if w.shape[0] < w.shape[-1]:
        kzyxio = w
    else:
        kzyxio = np.transpose(w, (1, 2, 3, 4, 0))
    kz, ky, kx, ci, co = kzyxio.shape
    return kzyxio.reshape(kz * ky * kx * ci, co)
