"""One-cycle Adam with decoupled weight decay (counterpart of
``one_cycle_lr``, ``one_cycle_momentum`` and ``build_one_cycle_optimizer``
in ``partner_tpu/train/optim.py:20-92``).

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
"""

import math

import torch


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


class OneCycleAdam:
    """The update of ``build_one_cycle_optimizer`` on a module's
    parameters, reading each parameter's ``.grad`` (None counts as zero,
    as a JAX gradient of an unused parameter is zero).

        opt = build_one_cycle_optimizer(module, lr_max=3e-3, total_steps=n)
        loss.backward(); grad_norm = opt.step()
    """

    def __init__(self, params, lr, momentum, wd=0.01, b2=0.99, eps=1e-8,
                 grad_clip=35.0):
        self.params = list(params)
        self.lr = lr
        self.momentum = momentum
        self.wd = wd
        self.b2 = b2
        self.eps = eps
        self.grad_clip = grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

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
        b1 = self.momentum(self.count)
        count = self.count + 1
        bc1 = float(1 - b1 ** count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** count)
        b1 = float(b1)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, g / g_norm * self.grad_clip)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_((u + self.wd * p) * -lr)
        self.count = count
        return g_norm

    def state_dict(self):
        """{"count", "mu", "nu"}: the step count and the two moments, lists
        in the order of ``params`` (``module.parameters()`` order)."""
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy ``state_dict()``'s count and moments in (onto the
        parameters' devices and dtypes)."""
        for key in ("mu", "nu"):
            if len(state[key]) != len(self.params):
                raise ValueError(f"{key}: {len(state[key])} moments for "
                                 f"{len(self.params)} parameters")
            for dst, src in zip(getattr(self, key), state[key]):
                if tuple(dst.shape) != tuple(src.shape):
                    raise ValueError(f"{key}: shape {tuple(src.shape)} for "
                                     f"a parameter of {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(state["count"])


def build_one_cycle_optimizer(module, lr_max, total_steps, wd=0.01,
                              moms=(0.95, 0.85), div_factor=10.0,
                              pct_start=0.4, grad_clip=35.0):
    """The flagship recipe (``optim.py:61-92``) on ``module``'s
    parameters: one-cycle lr and b1, Adam b2 0.99, weight decay ``wd`` on
    every parameter, global-norm clip ``grad_clip``."""
    return OneCycleAdam(module.parameters(),
                        one_cycle_lr(lr_max, total_steps, div_factor,
                                     pct_start),
                        one_cycle_momentum(moms, total_steps, pct_start),
                        wd=wd, grad_clip=grad_clip)
