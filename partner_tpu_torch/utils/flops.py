"""FLOP counting and MFU of the port (counterpart of
``partner_tpu/utils/flops.py``).

JAX walks the traced jaxpr (``per_module_flops``) and reads XLA's cost
analysis (``flops_of``). The port counts with
``torch.utils.flop_counter.FlopCounterMode``: every matmul-class aten op
(``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, SDPA) as it runs,
at each module on the stack that torch's module tracker sees. Elementwise
work is not counted, as in JAX's table.

The hand kernels are ``ctypes`` launches that the dispatcher never sees.
While a count is active (:func:`counting`), the stem, attention and block
wrappers (``ops/stem.py``, ``ops/swin_attn.py``, ``ops/swin_block.py``)
charge at each launch the matmul FLOPs that the counter gives their plain
twin at the same shapes (:func:`stem_flops`, :func:`swin_attn_flops`,
:func:`swin_block_flops`), to the modules that launched it; the
scatter-max's twin (``ops/scatter_max.py``) has no matmul and charges
nothing. So a frame's total is the same on the kernel route and on the
twins. With no count active a launch pays one ``if``.

Where the two packages' counts differ (each pinned by
``tests/test_torch_flops.py``):

- by definition, a transposed conv: torch counts each input pixel's
  products, 2 x in pixels x C_in x C_out x taps; XLA's lhs-dilated conv
  (``partner_tpu/utils/flops.py:_eqn_flops``) counts each output pixel's,
  the dilation's zeros included. JAX = torch x stride_h x stride_w ("SAME"
  padding, as the RPN's deblocks use);
- by definition, dead code: the jaxpr walk counts flax's ``(1, 2)`` probe
  call that binds an RPE or position MLP's parameters, 2 x (2 x hidden +
  hidden x heads) each, which XLA removes and the port never runs;
- by name: the tracker sees ``forward`` calls only, so what a submodule's
  other method computes (``PolarDenseFHD.encode_points``: the stem) counts
  under its caller; flax's name stack names the method;
- by formulation, not definition: the port's inference attention computes
  the RPE MLP's first layer per pair (the Pallas kernel's form, kept by
  ``csrc/swin_attn.cu`` and its twin), 2 x windows x T x T x 2 x hidden,
  where JAX's default XLA route computes it per cell, 2 x windows x T x 2
  x hidden;
- :func:`flops_of` is the matmul-class total; JAX's is XLA's count of the
  optimized program, elementwise work included.

Peaks: NVIDIA's data-sheet dense rates (no sparsity) by
``torch.cuda.get_device_name()``; a card not in the table raises unless
the caller gives ``peak``. No TPU figure belongs here.
"""

import contextlib

# FLOP/s by card name and number type: NVIDIA's data-sheet dense peaks
# (H100 SXM5 at 700 W), tensor-core bf16 and float32 outside the tensor
# cores; chip_smoke.bound reads them here too
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12},
}

# the FlopCounterModes counting now; the kernel wrappers charge each
active = []


@contextlib.contextmanager
def counting():
    """A ``FlopCounterMode`` (no display) that the kernel wrappers charge
    while it is open; yields it."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        active.append(mode)
        try:
            yield mode
        finally:
            active.remove(mode)


def charge(op, flops):
    """Count a hand kernel's ``flops`` under the name ``op`` in every
    active count, at each module on the stack (as the counter counts an
    aten op)."""
    for mode in active:
        for parent in set(mode.mod_tracker.parents):
            mode.flop_counts[parent][op] += int(flops)


def stem_flops(x, w1, w2):
    """The stem twin's matmul FLOPs: x (B, C_in, P), w1 (F1, C_in), w2
    (F2, F1)."""
    b, cin, p = x.shape
    f1, f2 = w1.shape[0], w2.shape[0]
    return 2 * b * p * (f1 * cin + f2 * f1)


def swin_attn_flops(q, w1, w2):
    """The attention twin's: q.k^T and P.v, and the RPE MLP per pair.
    q (nW, nh, T, hd), w1 (2, hidden), w2 (hidden, nh)."""
    nw, nh, t, hd = q.shape
    hid = w1.shape[1]
    return 2 * nw * t * t * (2 * nh * hd + 2 * hid + hid * nh)


def swin_block_flops(x, params, nh, ws):
    """The block twin's: the vote MLP, qkv, q.k^T, P.v, proj and the MLP.
    x (B, H, W, C), params from ``swin_vote_block_params``."""
    b, h, w, c = x.shape
    tokens, t = b * h * w, ws * ws
    m, vh = params["fc1_w"].shape[0], params["vote_w1"].shape[1]
    dense = 3 * vh + vh * c + 3 * c * c + c * c + 2 * m * c
    return 2 * tokens * dense + 4 * (tokens // t) * nh * t * t * (c // nh)


def module_table(counts, depth=3):
    """A ``FlopCounterMode.get_flop_counts()`` (each module's FLOPs with
    its submodules') -> {path: FLOPs of the ops run directly in it, its
    modules cut to the first ``depth`` names}, largest first. Paths join
    names with ``/`` (``VoxelNetModule/neck/Conv_0``), as JAX's table
    does; ops outside every module are ``<top>``. A module's own FLOPs are
    its count less those of the nearest counted modules below it."""
    totals = {k: sum(v.values()) for k, v in counts.items()}
    own = dict(totals)
    for name, n in totals.items():
        if name == "Global":
            continue
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            up = ".".join(parts[:i])
            if up in totals:
                own[up] -= n
                break
        else:
            own["Global"] -= n
    table = {}
    for name, n in own.items():
        if n:
            key = ("<top>" if name == "Global"
                   else "/".join(name.split(".")[:depth]))
            table[key] = table.get(key, 0) + n
    return dict(sorted(table.items(), key=lambda kv: -kv[1]))


def per_module_flops(fn, *args, depth=3, **kwargs):
    """Runs ``fn(*args, **kwargs)`` under a count -> its
    :func:`module_table`."""
    with counting() as mode:
        fn(*args, **kwargs)
    return module_table(mode.get_flop_counts(), depth)


def flops_of(fn, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` under a count -> its matmul-class
    FLOPs, as a float."""
    with counting() as mode:
        fn(*args, **kwargs)
    return float(mode.get_total_flops())


def device_peak_flops(dtype="bf16", name=None):
    """The data-sheet peak of card ``name`` (default: card 0) for
    ``dtype`` ("bf16" or "f32"); raises for a card not in
    PEAK_FLOPS."""
    if name is None:
        import torch

        name = torch.cuda.get_device_name(0)
    if name not in PEAK_FLOPS:
        raise KeyError(f"no peak FLOP/s for the card {name!r}; known: "
                       f"{sorted(PEAK_FLOPS)}; pass peak= to mfu")
    return PEAK_FLOPS[name][dtype]


def mfu(total_flops, seconds, peak=None):
    """Model FLOPs utilization: achieved FLOP/s over ``peak`` (default:
    card 0's bf16 peak)."""
    peak = peak or device_peak_flops()
    if seconds <= 0:
        return 0.0
    return total_flops / seconds / peak
