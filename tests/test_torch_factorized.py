"""``PolarDenseFHD(factorized=True)`` of partner_tpu_torch against the JAX
package's (CPU, f32): the 3D trunk with each 3x3x3 conv split into the
R(2+1)D pair (``partner_tpu/models/backbone_dense.py:44-103``) at a tiny
width, converted weights loaded by flax's names (``conv_bev`` /
``conv_z``, ``conv{k}_bev`` / ``conv{k}_z``), on a random canvas: in eval
mode the BEV map; in train mode the map, the BatchNorm statistics after
it and the gradients of ``sum(map * cot)`` by the canvas and every
parameter. No config sets the option, so no card phase runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import drawn_init, load_converted, randomize

torch.set_num_threads(2)

GRID = (64, 128, 40)     # canvas (cz, cy, cx) = (5, 32, 16)
PR = (0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0)
KW = dict(num_input_features=7, stem_features=(8, 16), stage_a_blocks=1,
          stage_b_blocks=1, factorized=True)


@pytest.fixture(scope="module")
def trunks():
    from partner_tpu.models.backbone_dense import PolarDenseFHD as JaxFHD
    from partner_tpu_torch.models.backbone_dense import PolarDenseFHD

    rng = np.random.RandomState(0)
    jm = JaxFHD(compute_dtype=jnp.float32, **KW)
    pts = np.zeros((1, 16, 7), np.float32)
    v = randomize(drawn_init(jm.init, rng, pts, np.zeros((1, 16), bool),
                             method=lambda m, p, k: m.encode_points(
                                 p, k, GRID, PR, train=False)), rng)
    tm = load_converted(PolarDenseFHD(compute_dtype="float32",
                                      input_shape=GRID, **KW), v)
    canvas = rng.randn(2, 5, 32, 16, 16).astype(np.float32)
    return jm, v, tm, canvas, rng


def _fold(canvas):
    """(B, cz, cy, cx, C) -> the port's z-folded (B, cy, cx, cz * C)."""
    b, cz, cy, cx, c = canvas.shape
    return torch.from_numpy(np.ascontiguousarray(
        canvas.transpose(0, 2, 3, 1, 4).reshape(b, cy, cx, cz * c)))


def test_factorized_blocks_carry_flax_names(trunks):
    """The stage convs hold ``conv_bev`` (1, 3, 3) and ``conv_z`` (3, 1,
    1), the z-squeeze its single conv; each residual block four convs."""
    _, _, tm, _, _ = trunks
    names = dict(tm.named_parameters())
    assert names["conv_b.conv_bev.weight"].shape == (32, 16, 1, 3, 3)
    assert names["conv_b.conv_z.weight"].shape == (32, 32, 3, 1, 1)
    assert names["extra_conv.Conv_0.weight"].shape == (32, 32, 3, 1, 1)
    for k in ("conv1", "conv2"):
        assert names[f"block_a0.{k}_bev.weight"].shape == (16, 16, 1, 3, 3)
        assert names[f"block_b0.{k}_z.weight"].shape == (32, 32, 3, 1, 1)


def test_factorized_trunk_eval_matches_jax(trunks):
    """Eval mode (running statistics): the BEV map."""
    jm, v, tm, canvas, _ = trunks
    ref, _ = jax.jit(lambda vv, c: jm.apply(vv, c, None, False,
                                            method=jm._trunk))(v, canvas)
    with torch.no_grad():
        got = tm.eval()._trunk(_fold(canvas))
    # 3x3 and 3-tap f32 convs of up to 48 channels in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_factorized_trunk_train_matches_jax(trunks):
    """Train mode (batch statistics): the map, the running statistics
    after it, and the gradients by the canvas and the parameters."""
    from partner_tpu_torch.convert import flax_to_torch

    jm, v, tm, canvas, rng = trunks
    with torch.no_grad():
        shape = tm.eval()._trunk(_fold(canvas)).shape
    cot = rng.randn(*shape).astype(np.float32)

    def f(params, c):
        (bev, _), upd = jm.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, c, None,
                                 True, method=jm._trunk,
                                 mutable=["batch_stats"])
        return jnp.sum(bev * cot), (bev, upd["batch_stats"])

    (gp, gc), (ref, stats) = jax.jit(jax.grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(canvas))
    x = _fold(canvas).requires_grad_()
    tm.train()
    got = tm._trunk(x)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, gp),
                          "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                stats)})
    sd = tm.state_dict()
    for k, t in sd.items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    for name, p in tm.named_parameters():
        if name.startswith("stem"):
            continue                     # the trunk does not reach the stem
        r = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=name)
    gx = x.grad.numpy().reshape(2, 32, 16, 5, 16).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(gx, np.asarray(gc), rtol=1e-3,
                               atol=1e-4 * float(np.abs(gc).max()))
