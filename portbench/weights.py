"""Seeded weights, made on the device in two draws: every kernel from
one normal draw at the variance of flax's lecun-normal initializer
(1 / fan in), every norm scale and statistic as the smoke script's
``randomize_norms`` draws them (scales and variances 0.5 + U[0, 1),
shifts and means 0.2 N(0, 1)), and every conv or dense bias at its
layer's constant initial value. With fresh LayerNorms the SetBlock's
keypoint choice would be rounding noise; drawn norms make it a function
of the input.

The plan is read off the benchmark's own reference module (its parameter
names, shapes and layer fan-ins), so the same seed gives the program and
the reference the same state."""

import torch

NORM_TYPES = ("LayerNorm", "BatchNorm", "MaskedBatchNorm", "GroupNorm",
              "RSNorm")


def plan(module):
    """[(name, shape, kind, arg)]: kind "normal" (arg: the std), "uniform"
    (0.5 + U), "shift" (0.2 N) or "const" (arg: the value), for every
    parameter and buffer of ``module`` in a fixed order."""
    out = []
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        is_norm = type(owner).__name__ in NORM_TYPES
        shape = tuple(t.shape)
        if hasattr(owner, "fan_in") and leaf == "weight":
            out.append((name, shape, "normal", owner.fan_in() ** -0.5))
        elif hasattr(owner, "fan_in") and leaf == "bias":
            out.append((name, shape, "const",
                        float(getattr(owner, "init_bias", None) or 0.0)))
        elif leaf == "kernel" or leaf.endswith("_kernel"):
            # a raw (fan in, out) kernel, as a sparse conv's (K * Cin, Cout)
            out.append((name, shape, "normal", shape[0] ** -0.5))
        elif leaf == "bias" and type(owner).__name__ == "SparseConv":
            out.append((name, shape, "const", 0.0))
        elif leaf in ("tau", "running_var", "var") or leaf.endswith(
                ("_scale", "_var")) or (is_norm and leaf in ("weight",
                                                             "scale")):
            out.append((name, shape, "uniform", None))
        elif leaf in ("running_mean", "mean") or leaf.endswith(
                ("_bias", "_mean")) or (
                is_norm and leaf == "bias"):
            out.append((name, shape, "shift", None))
        else:
            raise ValueError(f"no seeded draw for {name} "
                             f"({type(owner).__name__}.{leaf})")
    return out


def draw(module, seed, device):
    """{name: tensor on ``device``} for every entry of :func:`plan`,
    from ``seed``: one normal and one uniform draw of a generator on
    ``device``, float32."""
    entries = plan(module)
    size = lambda s: int(torch.Size(s).numel())
    n_normal = sum(size(s) for _, s, k, _ in entries
                   if k in ("normal", "shift"))
    n_uniform = sum(size(s) for _, s, k, _ in entries if k == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    state, i, j = {}, 0, 0
    for name, shape, kind, arg in entries:
        n = size(shape)
        if kind in ("normal", "shift"):
            scale = arg if kind == "normal" else 0.2
            state[name] = (normal[i:i + n] * scale).reshape(shape)
            i += n
        elif kind == "uniform":
            state[name] = (0.5 + uniform[j:j + n]).reshape(shape)
            j += n
        else:
            state[name] = torch.full(shape, arg, device=device)
    return state
