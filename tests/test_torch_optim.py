"""One-cycle Adam of partner_tpu_torch against the JAX package's optax
chain (CPU, f32): both schedules at their turning points, and three
updates of a small parameter tree, one of them clipped."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(2)


@pytest.mark.parametrize("total", [1000, 37])
def test_schedules_match_jax(total):
    from partner_tpu.train import optim as jo
    from partner_tpu_torch.train import optim

    split = int(0.4 * total)
    steps = [0, 1, split - 1, split, split + 1, total - 1, total]
    jl = jo.one_cycle_lr(3e-3, total)
    jmom = jo.one_cycle_momentum((0.95, 0.85), total)
    tl = optim.one_cycle_lr(3e-3, total)
    tmom = optim.one_cycle_momentum((0.95, 0.85), total)
    for s in steps:
        # one cos in f32 each
        np.testing.assert_allclose(float(tl(s)), float(jl(s)), rtol=1e-6,
                                   err_msg=f"lr at {s}")
        np.testing.assert_allclose(float(tmom(s)), float(jmom(s)),
                                   rtol=1e-6, err_msg=f"momentum at {s}")
    np.testing.assert_allclose(float(tl(0)), 3e-4, rtol=1e-6)
    np.testing.assert_allclose(float(tl(split)), 3e-3, rtol=1e-6)
    np.testing.assert_allclose(float(tl(total)), 3e-8, rtol=1e-5)
    np.testing.assert_allclose(float(tmom(split)), 0.85, rtol=1e-6)


def test_three_updates_match_optax(rng):
    """The same gradients into both optimizers for three steps (the second
    with a global norm above 35, so the clip acts): equal parameters, with
    weight decay on every tensor, biases included."""
    from partner_tpu.train.optim import build_one_cycle_optimizer as jopt
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer

    shapes = {"w": (6, 4), "b": (4,), "k": (3, 3, 2, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grad_scales = (1.0, 40.0, 0.3)        # global norms ~6, ~240, ~2

    module = torch.nn.Module()
    for k, a in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(a)))
    opt = build_one_cycle_optimizer(module, lr_max=3e-3, total_steps=10)
    tx = jopt(lr_max=3e-3, total_steps=10)
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    state = tx.init(jp)
    norms = []
    for s in grad_scales:
        grads = {k: (rng.randn(*shapes[k]) * s).astype(np.float32)
                 for k in shapes}
        updates, state = tx.update({k: jnp.asarray(g)
                                    for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        norms.append(float(opt.step()))
        np.testing.assert_allclose(
            norms[-1], float(optax.global_norm(grads)), rtol=1e-6)
        for k, p in module.named_parameters():
            # a few f32 elementwise ops per step
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert norms[1] > 35.0 > norms[0]
    assert opt.count == 3
    # the decay reaches the bias too: with a zero gradient it still moves
    module.b.grad = None
    before = module.b.detach().clone()
    opt.step()
    assert not torch.equal(before, module.b.detach())
