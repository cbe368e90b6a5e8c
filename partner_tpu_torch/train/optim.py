"""Optimizers and lr schedules (counterpart of
``partner_tpu/train/optim.py``): one-cycle Adam with decoupled weight
decay (``one_cycle_lr``, ``one_cycle_momentum``,
``build_one_cycle_optimizer``, ``:20-92``), and the reference's lr_updater
family with the config-built optimizer (``with_warmup``,
``build_lr_schedule``, ``build_optimizer``, ``:105-242``).

The JAX package's optax chain, written out as one update on tensors:

  1. clip by the global norm: ``g * (max_norm / ||g||)`` (as ``(g / ||g||)
     * max_norm``) only when ``||g|| >= max_norm``, with no eps;
  2. Adam, ``b2 = 0.99``, ``eps = 1e-8``, ``b1 = momentum(count)``, bias
     correction with the current ``b1``;
  3. ``+ wd * p`` on every parameter, biases and norms included (the
     reference decays them all);
  4. ``* -lr(count)``, then ``p += update``.

Both schedules are read at the step count before the update (0 on the
first step), in float32, as ``optax.inject_hyperparams`` reads them.

The family (:func:`build_optimizer`) is the same chain with another
scale, written out by the same :class:`ChainOptimizer`: Adam (``betas``
from the config, default ``(0.9, 0.99)``), AMSGrad (optax's ``scale_by_amsgrad`` defaults: b1 0.9,
b2 0.999) or SGD momentum (``optax.trace``: ``t = g + m t``, no
Nesterov); the decay ``wd * p`` is added to the scaled update of the
parameters its mask picks, then the whole is scaled by ``-lr(count)``.
``torch.optim.SGD(weight_decay=...)`` would fold the decay into the
gradient before the momentum: not this update.
"""

import math

import numpy as np
import torch

from ..convert import flax_param_path


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1)


def one_cycle_lr(lr_max, total_steps, div_factor=10.0, pct_start=0.4,
                 final_div=1e4):
    """step -> float32 lr: cosine from lr_max / div_factor up to lr_max
    over [0, split), then down to lr_max / (div_factor * final_div) at
    total, with split = int(pct_start * total_steps)."""
    low = lr_max / div_factor
    split = int(pct_start * total_steps)

    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        up = _annealing_cos(low, lr_max, step / max(split, 1))
        down = _annealing_cos(lr_max, low / final_div,
                              (step - split) / max(total_steps - split, 1))
        return torch.where(step < split, up, down)

    return sched


def one_cycle_momentum(moms, total_steps, pct_start=0.4):
    """step -> float32 Adam b1: cosine from moms[0] down to moms[1] over
    [0, split), then back up to moms[0] at total."""
    m0, m1 = moms
    split = int(pct_start * total_steps)

    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        down = _annealing_cos(m0, m1, step / max(split, 1))
        up = _annealing_cos(m1, m0,
                            (step - split) / max(total_steps - split, 1))
        return torch.where(step < split, down, up)

    return sched


class ChainOptimizer:
    """The update of the optax chains of ``build_one_cycle_optimizer`` and
    ``build_optimizer`` on a list of parameters, written out per tensor
    and reading each parameter's ``.grad`` (None counts as zero, as a JAX
    gradient of an unused parameter is zero):

      1. clip by the global norm;
      2. the scale: ``adam`` (``mu``, ``nu``, bias-corrected, ``eps``
         1e-8; ``betas[0]`` a number or a schedule of the count, one-cycle's
         momentum), ``amsgrad`` (the same moments and ``nu_max``, the
         running max of the bias-corrected ``nu``, in the denominator) or
         ``sgd`` (``trace = g + momentum x trace``);
      3. ``+ wd x p`` where ``decay`` (default: every parameter) is True;
      4. ``x -lr(count)``, then ``p += update``.

        opt = build_optimizer(cfg, build_lr_schedule(lr_cfg, n), module)
        loss.backward(); grad_norm = opt.step()

    ``state_dict()`` holds ``count`` and one list a slot (``mu``, ``nu``,
    ``nu_max`` or ``trace``) in the order of ``params``."""

    SLOTS = {"adam": ("mu", "nu"), "amsgrad": ("mu", "nu", "nu_max"),
             "sgd": ("trace",)}

    def __init__(self, params, lr, kind="adam", wd=0.0, decay=None,
                 betas=(0.9, 0.99), momentum=0.9, eps=1e-8, grad_clip=35.0):
        if kind not in self.SLOTS:
            raise ValueError(f"unknown optimizer type {kind!r}")
        self.params = list(params)
        self.lr = lr
        self.kind = kind
        self.wd = wd
        self.decay = ([True] * len(self.params) if decay is None
                      else list(decay))
        self.b1, self.b2 = betas
        self.momentum = momentum
        self.eps = eps
        self.grad_clip = grad_clip
        self.count = 0
        for k in self.SLOTS[kind]:
            setattr(self, k, [torch.zeros_like(p) for p in self.params])

    @torch.no_grad()
    def step(self):
        """One update; returns the global norm of the gradients before
        clipping (a 0-dim tensor on the parameters' device)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        g_norm = torch.sqrt(torch.stack(
            [(g.float() * g.float()).sum() for g in grads]).sum())
        keep = g_norm < self.grad_clip
        lr = float(self.lr(self.count))
        b1 = float(self.b1(self.count) if callable(self.b1) else self.b1)
        count = self.count + 1
        if self.kind != "sgd":   # 1 - b^count in float32, as XLA's pow
            one, n = np.float32(1), np.float32(count)
            bc1 = float(one - np.float32(b1) ** n)
            bc2 = float(one - np.float32(self.b2) ** n)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = torch.where(keep, g, g / g_norm * self.grad_clip)
            if self.kind == "sgd":
                t = self.trace[i]
                t.copy_(g + self.momentum * t)
                u = t
            else:
                mu, nu = self.mu[i], self.nu[i]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
                den = nu / bc2
                if self.kind == "amsgrad":
                    self.nu_max[i].copy_(torch.maximum(self.nu_max[i], den))
                    den = self.nu_max[i]
                u = (mu / bc1) / (torch.sqrt(den) + self.eps)
            if self.wd and self.decay[i]:
                u = u + self.wd * p
            p.add_(u * -lr)
        self.count = count
        return g_norm

    def state_dict(self):
        return dict({"count": self.count},
                    **{k: list(getattr(self, k)) for k in self.SLOTS[self.kind]})

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy ``state_dict()``'s count and slots in (onto the parameters'
        devices and dtypes); a slot this type lacks, or lacking one it
        has, raises."""
        want = set(self.SLOTS[self.kind])
        have = set(state) - {"count"}
        if have != want:
            raise KeyError(f"optimizer state holds {sorted(have)}; the "
                           f"{self.kind} update needs {sorted(want)}")
        for key in want:
            if len(state[key]) != len(self.params):
                raise ValueError(f"{key}: {len(state[key])} tensors for "
                                 f"{len(self.params)} parameters")
            for dst, src in zip(getattr(self, key), state[key]):
                if tuple(dst.shape) != tuple(src.shape):
                    raise ValueError(f"{key}: shape {tuple(src.shape)} for "
                                     f"a parameter of {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(state["count"])


def trainable_parameters(module):
    """``module``'s parameters that take gradients, in ``parameters()``
    order."""
    return [p for p in module.parameters() if p.requires_grad]


def build_one_cycle_optimizer(module, lr_max, total_steps, wd=0.01,
                              moms=(0.95, 0.85), div_factor=10.0,
                              pct_start=0.4, grad_clip=35.0):
    """The flagship recipe (``optim.py:61-92``) on ``module``'s trainable
    parameters (``requires_grad``; a frozen part is neither updated nor
    decayed): one-cycle lr and b1, Adam b2 0.99, weight decay ``wd`` on
    every parameter it holds, global-norm clip ``grad_clip``."""
    return ChainOptimizer(trainable_parameters(module),
                          one_cycle_lr(lr_max, total_steps, div_factor,
                                       pct_start),
                          "adam", wd=wd, grad_clip=grad_clip,
                          betas=(one_cycle_momentum(moms, total_steps,
                                                    pct_start), 0.99))


# ---------------------------------------------------------------------------
# the reference lr_updater family (``optim.py:96-242``): fixed / step / exp /
# poly / inv / cosine, each with an optional constant / linear / exp warmup,
# step -> float32 lr; ``by_epoch`` progress is floor(step / steps_per_epoch)
# ---------------------------------------------------------------------------


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def with_warmup(sched, warmup, warmup_iters, warmup_ratio=0.1):
    """``sched`` ramped over its first ``warmup_iters`` steps
    (``lr_updater.py:42-53``): ``constant`` (``ratio x lr``), ``linear``
    (from ``ratio x lr`` up to lr) or ``exp`` (``ratio ** (1 - t) x lr``),
    t the share of the warmup gone."""
    if not warmup or warmup_iters <= 0:
        return sched
    if warmup not in ("constant", "linear", "exp"):
        raise ValueError(f"unknown warmup {warmup!r}")

    def wrapped(step):
        step = _f32(step)
        regular = sched(step)
        frac = torch.clamp(step / warmup_iters, 0.0, 1.0)
        if warmup == "constant":
            w = regular * warmup_ratio
        elif warmup == "linear":
            w = regular * (1 - (1 - frac) * (1 - warmup_ratio))
        else:
            w = regular * torch.pow(_f32(warmup_ratio), 1 - frac)
        return torch.where(step < warmup_iters, w, regular)

    return wrapped


def build_lr_schedule(lr_config, total_steps, steps_per_epoch=None,
                      base_lr=None):
    """``lr_config`` (the reference's lr_config) -> step -> float32 lr.

    Types: ``one_cycle`` (:func:`one_cycle_lr`), ``fixed``, ``step`` (an
    int period or a list of bounds, ``gamma``), ``exp``, ``poly``
    (``power``, ``min_lr``), ``inv`` (``gamma``, ``power``) and ``cosine``
    (``target_lr``), from ``base_lr`` or the config's ``lr`` (1e-3);
    ``warmup``, ``warmup_iters``, ``warmup_ratio`` as :func:`with_warmup`.
    With ``by_epoch`` (the default) the progress is floor(step /
    steps_per_epoch), else the step."""
    cfg = dict(lr_config)
    kind = cfg.get("type", "one_cycle")
    if kind == "one_cycle":
        return one_cycle_lr(cfg.get("lr_max", base_lr or 3e-3), total_steps,
                            cfg.get("div_factor", 10.0),
                            cfg.get("pct_start", 0.4))
    lr0 = base_lr if base_lr is not None else cfg.get("lr", 1e-3)
    denom = max(int(steps_per_epoch or 1), 1) if cfg.get("by_epoch", True) \
        else 1
    max_progress = total_steps / denom

    def progress(step):
        return torch.floor(_f32(step) / denom)

    if kind == "fixed":
        def sched(step):
            return torch.full((), lr0, dtype=torch.float32)
    elif kind == "step":
        steps, gamma = cfg["step"], cfg.get("gamma", 0.1)
        if isinstance(steps, int):
            def sched(step):
                return lr0 * torch.pow(_f32(gamma),
                                       torch.floor(progress(step) / steps))
        else:
            bounds = torch.as_tensor(steps, dtype=torch.float32)

            def sched(step):
                n = (progress(step) >= bounds).sum().to(torch.float32)
                return lr0 * torch.pow(_f32(gamma), n)
    elif kind == "exp":
        gamma = cfg["gamma"]

        def sched(step):
            return lr0 * torch.pow(_f32(gamma), progress(step))
    elif kind == "poly":
        power, min_lr = cfg.get("power", 1.0), cfg.get("min_lr", 0.0)

        def sched(step):
            coeff = (1 - progress(step) / max_progress) ** power
            return (lr0 - min_lr) * coeff + min_lr
    elif kind == "inv":
        gamma, power = cfg["gamma"], cfg.get("power", 1.0)

        def sched(step):
            return lr0 * (1 + gamma * progress(step)) ** (-power)
    elif kind == "cosine":
        target = cfg.get("target_lr", 0.0)

        def sched(step):
            return target + 0.5 * (lr0 - target) * (
                1 + torch.cos(math.pi * progress(step) / max_progress))
    else:
        raise ValueError(f"unknown lr schedule type {kind!r}")
    return with_warmup(sched, cfg.get("warmup"), cfg.get("warmup_iters", 0),
                       cfg.get("warmup_ratio", 0.1))


def decay_mask(module, no_wd_patterns=()):
    """``module``'s trainable parameters -> which take the weight decay:
    more than one dimension, and no ``no_wd_patterns`` substring in the
    flax path (``convert.flax_param_path``), so one pattern picks the same
    tensors as in the JAX package."""
    return [p.dim() > 1 and not any(
        pat in flax_param_path(n, p.dim()) for pat in no_wd_patterns)
        for n, p in module.named_parameters() if p.requires_grad]


def build_optimizer(optimizer_cfg, lr_sched, module, grad_clip=35.0,
                    no_wd_patterns=()):
    """The config-built optimizer (``optim.py:184-242``) on ``module``'s
    trainable parameters: ``type`` adam / adamw (``betas``), amsgrad (or
    ``amsgrad=True``), or sgd (``momentum``, default 0.9); ``wd`` (or
    ``weight_decay``, default 0) on the parameters :func:`decay_mask`
    picks; ``lr_sched(count)`` the lr; the global-norm clip
    ``grad_clip``."""
    cfg = dict(optimizer_cfg)
    kind = cfg.get("type", "adam").lower()
    if kind in ("adam", "adamw", "amsgrad"):
        if kind == "amsgrad" or cfg.get("amsgrad"):
            kind, betas = "amsgrad", (0.9, 0.999)
        else:
            kind, betas = "adam", tuple(cfg.get("betas", (0.9, 0.99)))
    elif kind == "sgd":
        betas = (0.9, 0.99)
    else:
        raise ValueError(f"unknown optimizer type {kind!r}")
    return ChainOptimizer(
        trainable_parameters(module), lr_sched, kind,
        wd=cfg.get("wd", cfg.get("weight_decay", 0.0)),
        decay=decay_mask(module, no_wd_patterns), betas=betas,
        momentum=cfg.get("momentum", 0.9), grad_clip=grad_clip)
