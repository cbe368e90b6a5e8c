"""The lr schedule family and the config-built optimizer of
partner_tpu_torch (``train/optim.py``: ``with_warmup``,
``build_lr_schedule``, ``build_optimizer``) against the JAX package's
(``partner_tpu/train/optim.py:105-242``), and the checkpoints of their
state.

Schedules: every type and warmup shape at every step of a run, float32
on both sides, rtol 1e-6, and 1e-6 of the schedule's peak lr where its
value is small: XLA's float32 ``cos`` and torch's differ by an ulp on a
few percent of arguments, and near the cosine's end ``1 + cos`` cancels
(one ulp there was 2.4e-6 of the lr); the hand-computed cases of
``tests/test_lr_schedules.py`` mirrored. Optimizers: three steps of each
type, with weight decay and a ``no_wd_patterns`` mask, on the converted
parameters of a small neck against optax's chain on the flax tree, rtol
1e-5 (float32 elementwise math, the global norm summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (drawn_init, load_converted, randomize,
                                 tiny_frame_cfg)

RUN = 100          # steps of a run
SPE = 10           # steps an epoch
SCHEDULES = {
    "fixed": dict(type="fixed", lr=0.02),
    "step-int": dict(type="step", lr=1.0, step=2, gamma=0.1),
    "step-list": dict(type="step", lr=1.0, step=[3, 6], gamma=0.5),
    "exp": dict(type="exp", lr=1.0, gamma=0.5),
    "poly": dict(type="poly", lr=1.0, power=2.0, min_lr=0.1),
    "inv": dict(type="inv", lr=1.0, gamma=0.1, power=2.0),
    "cosine": dict(type="cosine", lr=1.0, target_lr=0.0),
    "cosine-target": dict(type="cosine", lr=0.01, target_lr=1e-4),
    "one-cycle": dict(type="one_cycle", lr_max=0.003, div_factor=10.0,
                      pct_start=0.4),
    "step-by-iter": dict(type="step", lr=0.1, step=[30, 70], gamma=0.1,
                         by_epoch=False),
    "poly-by-iter": dict(type="poly", lr=0.01, power=0.9, by_epoch=False),
    "cosine-linear": dict(type="cosine", lr=0.01, warmup="linear",
                          warmup_iters=20, warmup_ratio=0.001),
    "step-constant": dict(type="step", lr=0.02, step=[4, 8],
                          warmup="constant", warmup_iters=15,
                          warmup_ratio=0.3),
    "exp-exp": dict(type="exp", lr=0.1, gamma=0.9, warmup="exp",
                    warmup_iters=25, warmup_ratio=0.1),
    "inv-linear-by-iter": dict(type="inv", lr=0.1, gamma=1e-3, power=0.75,
                               by_epoch=False, warmup="linear",
                               warmup_iters=7),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax_at_every_step(name):
    from partner_tpu.train.optim import build_lr_schedule as jax_sched
    from partner_tpu_torch.train.optim import build_lr_schedule

    cfg = SCHEDULES[name]
    got = build_lr_schedule(cfg, RUN, steps_per_epoch=SPE)
    want = jax.jit(jax.vmap(jax_sched(cfg, RUN, steps_per_epoch=SPE)))(
        jnp.arange(RUN + 1))
    got = np.array([float(got(s)) for s in range(RUN + 1)], np.float32)
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.max()))
    assert float(build_lr_schedule(cfg, RUN, SPE)(torch.tensor(5))) == \
        got[5]


def test_schedules_by_hand():
    """The hand-computed values of ``tests/test_lr_schedules.py``."""
    from partner_tpu_torch.train.optim import build_lr_schedule, with_warmup

    v = lambda s, step: float(s(step))
    b = lambda cfg: build_lr_schedule(cfg, 100, steps_per_epoch=10)
    s = build_lr_schedule(dict(type="fixed", lr=0.02), 100)
    assert v(s, 0) == v(s, 99) == pytest.approx(0.02)
    s = b(dict(type="step", lr=1.0, step=2, gamma=0.1))
    assert [v(s, i) for i in (0, 19, 20, 45)] == pytest.approx(
        [1.0, 1.0, 0.1, 0.01])
    s = b(dict(type="step", lr=1.0, step=[3, 6], gamma=0.5))
    assert [v(s, i) for i in (25, 30, 60)] == pytest.approx([1.0, 0.5, 0.25])
    assert v(b(dict(type="exp", lr=1.0, gamma=0.5)), 35) == pytest.approx(
        0.5 ** 3)
    assert v(b(dict(type="poly", lr=1.0, power=2.0, min_lr=0.1)), 50) == \
        pytest.approx(0.9 * (1 - 5 / 10) ** 2 + 0.1)
    assert v(b(dict(type="inv", lr=1.0, gamma=0.1, power=2.0)), 45) == \
        pytest.approx((1 + 0.1 * 4) ** -2.0)
    s = b(dict(type="cosine", lr=1.0, target_lr=0.0))
    assert v(s, 0) == pytest.approx(1.0)
    assert v(s, 50) == pytest.approx(0.5, abs=1e-6)
    base = lambda step: torch.tensor(1.0)
    lin = with_warmup(base, "linear", 10, warmup_ratio=0.1)
    assert [v(lin, i) for i in (0, 5, 10)] == pytest.approx(
        [0.1, 1 - 0.5 * 0.9, 1.0])
    const = with_warmup(base, "constant", 10, warmup_ratio=0.3)
    assert [v(const, 3), v(const, 10)] == pytest.approx([0.3, 1.0])
    assert v(with_warmup(base, "exp", 10, warmup_ratio=0.1), 5) == \
        pytest.approx(0.1 ** 0.5)
    s = b(dict(type="one_cycle", lr_max=0.003, div_factor=10.0,
               pct_start=0.4))
    assert v(s, 0) == pytest.approx(0.0003)
    assert v(s, 40) == pytest.approx(0.003, rel=1e-3)
    with pytest.raises(ValueError, match="unknown lr schedule"):
        b(dict(type="linear"))
    with pytest.raises(ValueError, match="unknown warmup"):
        with_warmup(base, "cubic", 10)


NECK = dict(layer_nums=(1, 1), ds_layer_strides=(1, 2),
            ds_num_filters=(8, 16), us_layer_strides=(1, 2),
            us_num_filters=(8, 8), num_input_features=6)
OPTIMIZERS = {
    "adam": dict(type="adam", wd=0.05),
    "adamw-betas": dict(type="adamw", betas=(0.8, 0.95), weight_decay=0.1),
    "amsgrad": dict(type="amsgrad", wd=0.01),
    "adam-amsgrad-flag": dict(type="adam", amsgrad=True, wd=0.02),
    "sgd": dict(type="sgd", momentum=0.9, wd=0.01),
    "sgd-no-wd": dict(type="sgd", momentum=0.5),
}
PATTERNS = ("deblock1", "block0_conv1")


@pytest.fixture(scope="module")
def neck():
    """A small RPNHalo neck: flax variables (randomized) and the port
    module holding them."""
    from partner_tpu.models.rpn_stream import RPNHalo as JHalo
    from partner_tpu_torch.models.rpn_stream import RPNHalo

    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 8, 6).astype(np.float32)
    v = randomize(drawn_init(JHalo(**NECK).init, rng, x, train=False), rng)
    return v, lambda: load_converted(RPNHalo(**NECK), v)


def _grads(v, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 3).astype(np.float32), v["params"])


@pytest.mark.parametrize("clip", [35.0, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_optax(neck, name, clip, tmp_path):
    """Three updates with gradients drawn per step, the lr a cosine
    schedule after a linear warmup, the decay masked by ``PATTERNS``
    (their kernels decay neither, nor does a vector): the parameters after
    each step and the global norm against optax's on the flax tree; then
    the state saved by the train CLI's checkpoint and restored into a
    fresh optimizer continues bit-equal, and the JAX checkpoint of the
    same state reads into the port's slots."""
    from partner_tpu.train.checkpoint import save_checkpoint as jax_save
    from partner_tpu.train.optim import build_lr_schedule as jax_sched
    from partner_tpu.train.optim import build_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.train import checkpoint as ck
    from partner_tpu_torch.train.optim import (build_lr_schedule,
                                               build_optimizer, decay_mask)

    v, make = neck
    lr_cfg = dict(type="cosine", lr=0.01, warmup="linear", warmup_iters=2,
                  by_epoch=False)
    cfg = OPTIMIZERS[name]
    tx = jax_opt(cfg, jax_sched(lr_cfg, 10), grad_clip=clip,
                 no_wd_patterns=PATTERNS)
    params, state = v["params"], None
    state = tx.init(params)
    jstep = jax.jit(lambda p, s, g: tx.update(g, s, p))
    module = make()
    opt = build_optimizer(cfg, build_lr_schedule(lr_cfg, 10), module,
                          grad_clip=clip, no_wd_patterns=PATTERNS)
    names = [n for n, _ in module.named_parameters()]
    mask = dict(zip(names, decay_mask(module, PATTERNS)))
    assert mask["block0_conv0.weight"] and not mask["block0_conv1.weight"]
    assert not mask["deblock1_conv.weight"] and mask["deblock0_conv.weight"]
    assert not any(m for n, m in mask.items() if n.endswith(".bias"))
    for i in range(3):
        g = _grads(v, i)
        upd, state = jstep(params, state, g)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        tg = flax_to_torch({"params": g})
        for n, p in module.named_parameters():
            p.grad = tg[n].clone()
        norm = float(opt.step())
        want_norm = float(jnp.sqrt(sum(jnp.sum(a * a) for a in
                                       jax.tree_util.tree_leaves(g))))
        assert norm == pytest.approx(want_norm, rel=1e-5)
        want = flax_to_torch({"params": params})
        for n, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=(i, n))

    class Det:
        pass

    det = Det()
    det.module = module
    ck.save_checkpoint(str(tmp_path / "port"), 3, module.state_dict(),
                       opt_state=ck.optimizer_state(module, opt))
    payload, _ = ck.load_checkpoint(str(tmp_path / "port" / "latest"))
    det2 = Det()
    det2.module = make()
    opt2 = build_optimizer(cfg, build_lr_schedule(lr_cfg, 10), det2.module,
                           grad_clip=clip, no_wd_patterns=PATTERNS)
    assert ck.restore_train_state(det2, opt2, payload) == 3
    assert opt2.count == opt.count == 3
    for a, b in zip(opt.state_dict().items(), opt2.state_dict().items()):
        assert a[0] == b[0]
        if a[0] != "count":
            assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    tg = flax_to_torch({"params": _grads(v, 3)})
    for o, m in ((opt, module), (opt2, det2.module)):
        for n, p in m.named_parameters():
            p.grad = tg[n].clone()
        o.step()
    for (n, p), (_, q) in zip(module.named_parameters(),
                              det2.module.named_parameters()):
        assert torch.equal(p, q), n

    jstate = create_train_state(v, tx).replace(
        params=params, opt_state=state, step=3)
    jax_save(str(tmp_path / "jax"), jstate)
    jp, _ = ck.load_checkpoint(str(tmp_path / "jax" / "latest"))
    det3 = Det()
    det3.module = make()
    opt3 = build_optimizer(cfg, build_lr_schedule(lr_cfg, 10), det3.module,
                           grad_clip=clip, no_wd_patterns=PATTERNS)
    ck.restore_train_state(det3, opt3, jp)
    assert opt3.count == 3
    mine = opt2.state_dict()
    assert sorted(opt3.state_dict()) == sorted(mine)
    # opt2 stepped once more: compare with the state before (from opt's
    # checkpoint payload)
    for k, vals in payload["opt_state"].items():
        if k == "count":
            continue
        for n, t in vals.items():
            # (a trace element that cancels over the steps carries the
            # clip's rounding at the slot's scale)
            j = jp["opt_state"][k][n].numpy()
            np.testing.assert_allclose(j, t.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(j).max()),
                                       err_msg=(k, n))


def test_restore_refuses_another_optimizer_type(neck, tmp_path):
    """A checkpoint of one type's state does not load into another's."""
    from partner_tpu_torch.train import checkpoint as ck
    from partner_tpu_torch.train.optim import (build_lr_schedule,
                                               build_optimizer)

    _, make = neck

    class Det:
        pass

    det = Det()
    det.module = make()
    sched = build_lr_schedule(dict(type="fixed", lr=0.1), 10)
    adam = build_optimizer(dict(type="adam"), sched, det.module)
    sgd = build_optimizer(dict(type="sgd"), sched, det.module)
    payload = {"step": 0, "state_dict": det.module.state_dict(),
               "opt_state": ck.optimizer_state(det.module, adam)}
    with pytest.raises(KeyError, match="the sgd update needs"):
        ck.restore_train_state(det, sgd, payload)
    with pytest.raises(ValueError, match="unknown optimizer type"):
        build_optimizer(dict(type="lamb"), sched, det.module)


def test_decay_mask_reads_flax_paths():
    """Every port parameter of more than one dimension maps back to its
    flax path (``convert.flax_param_path``), so a ``no_wd_patterns``
    substring picks the same tensors in both packages: the tiny flagship's
    whole tree."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.convert import flax_param_path
    from partner_tpu_torch.models import build_detector

    m, tc = tiny_frame_cfg()
    jdet = jax_build(m, None, tc)
    shapes = jax.eval_shape(jdet.init, jax.random.PRNGKey(0), {
        "points": jnp.zeros((1, 64, 7)),
        "points_mask": jnp.zeros((1, 64), bool)})["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = {"/".join(str(k.key) for k in path) for path, a in flat
            if len(a.shape) > 1}
    det = build_detector(m, None, tc, device="meta")
    got = {flax_param_path(n, p.dim()) for n, p in
           det.module.named_parameters() if p.dim() > 1}
    assert got == want
