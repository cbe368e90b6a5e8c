"""The train step of partner_tpu_torch against the JAX package (CPU, f32).

The scatter-max backward with the JAX package's tie rule, the train-mode
modules (BatchNorm batch statistics, the stem's train branch, the
SetBlock's direct pair bias, Dropout and DropPath), the refusal of the raw
kernel wrappers to take inputs that need a gradient, and one whole train
step of the tiny flagship config against ``make_train_step``.

Randomness cannot match JAX (another generator), so every parity test
runs with all drop rates at 0; DropPath and Dropout get their own
semantic test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (TINY_GRID, jax_init, load_converted,
                                 randomize, tiny_frame_cfg)

torch.set_num_threads(2)


def _torch_grads(grads):
    """A flax gradient tree (the params' tree) -> torch names and layouts."""
    from partner_tpu_torch.convert import flax_to_torch

    return flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                           grads)})


def _scatter_inputs(rng, shape=(3, 8, 6), b=2, p=500, c=4):
    """Channel-major post-ReLU rows on a 0.25 grid (many ties, a third of
    them zero), some -0.0 values, masked rows."""
    feats = np.maximum(np.round(rng.randn(b, c, p) * 4) / 4, 0.0)
    feats[rng.rand(b, c, p) < 0.2] = -0.0
    coords = np.stack([rng.randint(0, s, (b, p)) for s in shape],
                      1).astype(np.int32)                   # (b, 3, p)
    mask = rng.rand(b, p) > 0.3
    return feats.astype(np.float32), coords, mask


def test_scatter_max_backward_gives_every_tied_winner_the_cotangent(rng):
    from partner_tpu.models.backbone_dense import _scatter_max_rows
    from partner_tpu_torch.ops.scatter_max import ScatterMaxFold2d

    shape = (3, 8, 6)
    cz, cy, cx = shape
    cells = cz * cy * cx
    feats, coords, mask = _scatter_inputs(rng, shape)
    b, c, _ = feats.shape
    g = rng.randn(b, cy, cx, cz * c).astype(np.float32)

    # JAX: the z-minor cell index of scatter_canvas(fold2d=True), masked
    # rows sent to the dump row, through the custom VJP
    lin = (coords[:, 1] * cx + coords[:, 2]) * cz + coords[:, 0]
    lin = np.where(mask, lin, cells).astype(np.int32)
    fwd = jax.vmap(lambda v, l: _scatter_max_rows(v, l, cells, True))
    out, vjp = jax.vjp(lambda v: fwd(v, jnp.asarray(lin)),
                       jnp.asarray(feats.transpose(0, 2, 1)))
    (ref,) = vjp(jnp.asarray(g.reshape(b, cells, c)))
    ref = np.asarray(ref).transpose(0, 2, 1)                # (b, c, p)

    x = torch.from_numpy(feats).requires_grad_()
    canvas = ScatterMaxFold2d.apply(x, torch.from_numpy(coords),
                                    torch.from_numpy(mask), shape)
    np.testing.assert_array_equal(canvas.detach().numpy(),
                                  np.asarray(out).reshape(b, cy, cx, cz * c))
    canvas.backward(torch.from_numpy(g))
    got = x.grad.numpy()
    # a gather, a compare and a select: exact
    np.testing.assert_array_equal(got, ref)
    # the case is real: cells with two or more winners that each take the
    # full cotangent, -0.0 rows among them, and masked rows that take none
    gsel = np.take_along_axis(g.reshape(b, cells, c),
                              np.minimum(lin, cells - 1)[..., None],
                              axis=1).transpose(0, 2, 1)
    winners = (got != 0) & (got == gsel)
    assert winners.sum() == (got != 0).sum() > 0
    assert (np.signbit(feats) & (feats == 0) & winners).any()
    for i in range(b):
        assert not got[i][:, ~mask[i]].any()
    cell_wins = np.zeros((b, cells, c), int)
    for i in range(b):
        np.add.at(cell_wins[i], lin[i][mask[i]],
                  winners[i].T[mask[i]].astype(int))
    assert (cell_wins > 1).any()


@pytest.mark.parametrize("eps,momentum", [(1e-3, 0.99), (1e-5, 0.9)],
                         ids=["trunk", "head"])
@pytest.mark.parametrize("stats", ["unit", "eps-sized", "offset"])
def test_train_batchnorm_matches_flax(rng, eps, momentum, stats):
    """Batch mean and biased variance (flax's E[x^2] - E[x]^2), the running
    update with each site's momentum, and the backward through the batch
    statistics; "eps-sized" variances make a wrong eps show, "offset" puts
    a mean 4x the spread under the variance."""
    import flax.linen as fnn

    from partner_tpu_torch.models.layers import BatchNorm

    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    if stats == "eps-sized":
        x *= np.sqrt(eps)
    elif stats == "offset":
        x = 4.0 + x
    c = x.shape[-1]
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(0, 0.2, c).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(0, 0.2, c).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    jm = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=eps)
    cot = rng.randn(*x.shape).astype(np.float32)

    def f(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (gp, gx), (ref, new_stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    tm = load_converted(BatchNorm(c, eps, momentum), v).train()
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    # elementwise f32 math over reductions of 70 rows: rounding only
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(new_stats["mean"]), **tol)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(new_stats["var"]), **tol)
    # the backward through the statistics, summed in another order
    gtol = dict(rtol=1e-4, atol=1e-4 * float(np.abs(gx).max()))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **gtol)
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(gp["scale"]), **gtol)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(gp["bias"]),
                               **gtol)


def _jax_fhd(rng, grid, pr, kw, pts, mask):
    from partner_tpu.models.backbone_dense import PolarDenseFHD as JaxFHD

    jm = JaxFHD(compute_dtype=jnp.float32, **kw)
    v = randomize(jax_init(jm, pts, mask, method=lambda m, p, k: (
        m.encode_points(p, k, grid, pr, train=False))), rng)
    return jm, v


def test_stem_train_branch_matches_jax(rng):
    """``_stem_t(train=True)``: statistics over every (B, P) position, the
    masked zeros included, momentum 0.99 on ``stem{i}_mean/var``, and the
    gradients of the stem parameters and the input."""
    from partner_tpu_torch.models.backbone_dense import PolarDenseFHD

    from torch_port_fixtures import synthetic_points

    grid = (64, 128, 40)
    pr = (0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0)
    kw = dict(num_input_features=7, trunk2d=True, a2d_features=16,
              out_features=24)
    pts, mask = synthetic_points(rng, pr, 90, 100)
    jm, v = _jax_fhd(rng, grid, pr, kw, pts, mask)
    x = rng.randn(2, 10, 120).astype(np.float32)
    m = rng.rand(2, 120) > 0.3
    cot = rng.randn(2, 64, 120).astype(np.float32)

    def f(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx, m, True,
                          method=jm._stem_t, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (gp, gx), (ref, new_stats) = jax.jit(
        jax.grad(f, argnums=(0, 1), has_aux=True))(v["params"],
                                                   jnp.asarray(x))
    tm = load_converted(PolarDenseFHD(compute_dtype="float32",
                                      input_shape=grid, **kw), v).train()
    xt = torch.from_numpy(x).requires_grad_()
    out = tm._stem_t(xt, torch.from_numpy(m))
    assert out.is_contiguous()          # the scatter kernel reads (B, F, P)
    (out * torch.from_numpy(cot)).sum().backward()
    # K = 10 and 32 f32 products and 240-position statistics: rounding
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for i in range(2):
        for s in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(tm, f"stem{i}_{s}").numpy(),
                np.asarray(new_stats[f"stem{i}_{s}"]), rtol=1e-5, atol=1e-6)
    grads = _torch_grads(gp)
    for name, p in tm.named_parameters():
        if name.startswith("stem"):
            r = grads[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(r).max()),
                                       err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(gx).max()))


def test_set_block_train_mode_matches_jax(rng):
    """The SetBlock in train mode: each pair bias on the direct (..., 2)
    pair tensor with its BatchNorm's batch statistics (the decomposed
    inference branch would be wrong there), the running statistics after
    the step, and the gradients; drop rates 0."""
    from partner_tpu.models.set_transformer import SetBlockStack as JSB
    from partner_tpu_torch.models.set_transformer import SetBlockStack

    b, h, w, c = 2, 12, 16, 32
    x = rng.randn(b, h, w, c).astype(np.float32)
    pos = (rng.randn(b, h, w, 2) * 20).astype(np.float32)
    kw = dict(depth=2, num_heads=4, num_keypoints=4, range_window=8,
              drop=0.0, attn_drop=0.0, drop_path=0.0)
    jm = JSB(**kw)
    v = randomize(jax_init(jm, x, pos, train=False), rng)
    cot = rng.randn(*x.shape).astype(np.float32)

    def f(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx, pos,
                          deterministic=True, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (gp, gx), (ref, new_stats) = jax.jit(
        jax.grad(f, argnums=(0, 1), has_aux=True))(v["params"],
                                                   jnp.asarray(x))
    tm = load_converted(SetBlockStack(c, **kw), v).train()
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, torch.from_numpy(pos))
    (out * torch.from_numpy(cot)).sum().backward()
    # f32 products and softmaxes in another summation order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    from partner_tpu_torch.convert import flax_to_torch

    want = flax_to_torch({"batch_stats": jax.tree_util.tree_map(
        np.asarray, new_stats)})
    got = tm.state_dict()
    assert want and all(k in got for k in want)
    for k, r in want.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    grads = _torch_grads(gp)
    gmax = max(float(np.abs(r.numpy()).max()) for r in grads.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-3, atol=1e-5 * gmax,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(gx).max()))


def test_drop_path_and_dropout_semantics():
    """Identity in eval mode and at rate 0; DropPath keeps or drops whole
    samples, Dropout single elements, with keep probability 1 - rate and
    the kept values scaled by 1 / keep; the same generator seed gives the
    same mask."""
    from partner_tpu_torch.models.layers import Dropout, DropPath

    x = torch.ones(4000, 3, 5)
    for cls in (DropPath, Dropout):
        mod = cls(0.25)
        g = torch.Generator().manual_seed(3)
        assert mod.eval()(x, g) is x
        assert cls(0.0).train()(x, g) is x
        y = mod.train()(x, g)
        keep = 0.75
        assert set(torch.unique(y).tolist()) == {
            0.0, float(torch.tensor(1.0) / keep)}
        frac = float((y != 0).float().mean())
        assert abs(frac - keep) < 0.02        # 60k/4k draws: ~7 sigma
        again = mod(x, torch.Generator().manual_seed(3))
        assert torch.equal(y, again)
        assert not torch.equal(y, mod(x, g))  # the generator moved on
        if cls is DropPath:                   # one draw per sample
            assert torch.equal(y, y[:, :1, :1].expand_as(y))
        else:
            assert not torch.equal(y, y[:, :1, :1].expand_as(y))
    with pytest.raises(ValueError, match="Generator"):
        DropPath(0.1).train()(x, None)


def _wrapper_inputs(rng):
    """Tiny valid inputs for each of the four raw kernel wrappers (their
    CPU twins run)."""
    from partner_tpu_torch.models.layers import init_weights
    from partner_tpu_torch.models.swin_vote import SwinVoteBlock
    from partner_tpu_torch.ops import swin_block

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    stem_args = [t(rng.randn(1, 10, 16)), torch.ones(1, 16, dtype=bool),
                 t(rng.randn(32, 10)), t(np.ones(32)), t(np.zeros(32)),
                 t(rng.randn(64, 32)), t(np.ones(64)), t(np.zeros(64))]
    feats, coords, mask = _scatter_inputs(rng)
    scatter_args = [t(feats), torch.from_numpy(coords),
                    torch.from_numpy(mask), (3, 8, 6)]
    attn_args = [t(rng.randn(1, 4, 64, 64)), t(rng.randn(1, 4, 64, 64)),
                 t(rng.randn(1, 4, 64, 64)), t(rng.randn(1, 64, 2)), None,
                 t(rng.randn(2, 16)), t(np.zeros(16)), t(rng.randn(16, 4)),
                 t(np.zeros(4)), t(np.ones(4))]
    block = SwinVoteBlock(256, 4, 8)
    init_weights(block, torch.Generator().manual_seed(0))
    params = swin_block.swin_vote_block_params(block, torch.float32)
    pos = t(rng.randn(1, 8, 8, 2))
    bias = swin_block.block_bias_table(pos, None, params["rpe"],
                                       torch.float32, 8)
    block_args = [t(rng.randn(1, 8, 8, 256)), t(rng.randn(1, 8, 8, 3)), bias,
                  params, 4, 8]
    return {"stem": stem_args, "scatter_max": scatter_args,
            "swin_attn": attn_args, "swin_block": block_args}


def test_raw_wrappers_refuse_inputs_that_need_grad(rng):
    """A kernel wrapper returns a fresh tensor with no grad_fn: called on
    an input that needs a gradient under grad mode it raises, on every
    device, instead of training with zero gradients upstream of it."""
    from partner_tpu_torch.ops import scatter_max, stem, swin_attn, swin_block

    fns = {"stem": stem.stem2_channel_major,
           "scatter_max": scatter_max.scatter_max_fold2d,
           "swin_attn": swin_attn.swin_vote_attention,
           "swin_block": swin_block.swin_vote_block}
    for name, args in _wrapper_inputs(rng).items():
        fns[name](*args)                        # no input needs a gradient
        args[0].requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            fns[name](*args)
        with torch.no_grad():
            fns[name](*args)


def _step_example(rng, m, b=2):
    """The JAX package's synthetic flagship batch on the tiny grid, as
    numpy: points, boxes and vote maps."""
    from partner_tpu import testing

    pr = m["bbox_head"]["voxel_generator"]["range"]
    vs = [(pr[3 + i] - pr[i]) / TINY_GRID[i] for i in range(3)]
    ex = testing.make_flagship_example(
        rng, grid=TINY_GRID, pc_range=pr, voxel_size=vs, b=b, n_points=1200,
        cap=2048, point_dim=7, max_objs=8)
    return {k: np.array(a) for k, a in ex.items()}


@pytest.mark.parametrize("use_block_kernel", [False, True],
                         ids=["per-block", "whole-block"])
def test_train_forward_never_calls_the_kernel_wrappers(rng, monkeypatch,
                                                       use_block_kernel):
    """Train mode routes around the stem, attention and block kernels, as
    the JAX package gates them, and reaches the scatter-max only inside
    its autograd Function (grad mode off): with the wrappers patched to
    raise, a tiny train forward and backward runs and every parameter
    gets a gradient."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.ops import scatter_max, stem, swin_attn, swin_block

    def refuse(name, only_under_grad=False):
        def fn(*args, **kwargs):
            if not only_under_grad or torch.is_grad_enabled():
                raise AssertionError(f"train mode called {name}")
            return plain(*args, **kwargs)
        return fn

    plain = scatter_max.scatter_max_fold2d
    monkeypatch.setattr(stem, "stem2_channel_major", refuse("stem"))
    monkeypatch.setattr(swin_attn, "swin_vote_attention",
                        refuse("swin_attn"))
    monkeypatch.setattr(swin_block, "swin_vote_block", refuse("swin_block"))
    monkeypatch.setattr(scatter_max, "scatter_max_fold2d",
                        refuse("scatter_max", only_under_grad=True))
    m, tc = tiny_frame_cfg()
    det = build_detector(m, None, tc, device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         use_block_kernel=use_block_kernel)
    ex = {k: torch.from_numpy(a) for k, a in _step_example(rng, m).items()}
    det.module.train()
    losses = det.loss(ex, torch.Generator().manual_seed(1))
    losses["loss"].backward()
    assert torch.isfinite(losses["loss"])
    for name, p in det.module.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_whole_train_step_matches_jax(rng, monkeypatch):
    """One step of the tiny flagship config, f32, drop rates 0, b = 2,
    against ``jax.jit(make_train_step(det, tx))`` built from the same
    converted weights and example: the loss terms, ``num_matched``, the
    assignment, the gradients (the JAX step's own, read back from Adam's
    first moment), and the parameters and batch_stats after the step.

    The example is closed over as a constant of the jitted JAX step. Given
    as a traced argument instead, XLA compiles the same step so that its
    gradients upstream of the head move by up to 0.8% (relative RMS per
    tensor) while the head's do not; the port agrees with the constant
    compile to ~1e-5, well inside that spread of the reference itself."""
    from partner_tpu.losses import matcher as jmatcher
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.models import e2e_head as je
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch
    from partner_tpu_torch.losses import set_crit
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    m, tc = tiny_frame_cfg()
    m["neck"] = dict(m["neck"], set_drop=0.0, set_attn_drop=0.0,
                     set_drop_path=0.0)
    ex = _step_example(rng, m)
    jdet = jax_build(m, None, tc)
    v = randomize(jdet.init(jax.random.PRNGKey(0), {
        "points": ex["points"][:, :64],
        "points_mask": ex["points_mask"][:, :64]}), rng)
    lr_max, total = 3e-3, 1000
    tx = jax_opt(lr_max=lr_max, total_steps=total)
    step = jax_step(jdet, tx)
    key = jax.random.PRNGKey(1)
    new_state, jmet = jax.jit(lambda s: step(s, ex, key))(
        create_train_state(v, tx))

    def assignment():
        preds, _ = jdet.forward(v, ex, key, train=True)
        flat = je.flatten_head_preds(preds, jdet.offset_grid)
        gt = ex["global_box"]
        gt_boxes = jnp.concatenate([gt[..., :6], gt[..., -2:-1]], -1)
        crit = jdet.criterion
        return jmatcher.assign_auction(
            flat["pred_logits"], flat["pred_boxes"],
            jnp.maximum((gt[..., -1] - 1).astype(jnp.int32), 0),
            crit.coder.encode(gt_boxes), ex["global_box_mask"],
            crit.code_weights)

    jassigned = np.asarray(jax.jit(assignment)())

    det = build_detector(m, None, tc, device="cpu")
    load_converted(det.module, v)
    opt = build_one_cycle_optimizer(det.module, lr_max, total)
    seen = []
    record = set_crit.assign_auction
    monkeypatch.setattr(set_crit, "assign_auction",
                        lambda *a, **k: seen.append(record(*a, **k))
                        or seen[-1])
    met = make_train_step(det, opt)(
        {k: torch.from_numpy(a) for k, a in ex.items()},
        torch.Generator().manual_seed(0))

    assert sorted(met) == sorted(jmet)
    assert int(met["num_matched"]) == int(jmet["num_matched"]) > 0
    np.testing.assert_array_equal(seen[0].numpy(), jassigned)
    # f32 forward in another summation order: ~1e-6 measured
    for k in ("loss", "loss_ce", "loss_bbox", "loss_vote", "loss_vote_cls",
              "loss_iou", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)

    # the JAX step's clipped gradients: Adam's first moment after one step
    # is (1 - b1) * clip(g), with b1 = momentum(0) in float32
    b1 = np.float32(0.95)
    want = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) / (np.float32(1) - b1),
        new_state.opt_state.inner_state[1].mu)})
    scale = min(1.0, 35.0 / float(met["grad_norm"]))
    params = dict(det.module.named_parameters())
    assert sorted(want) == sorted(params)
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in params.items():
        assert p.grad is not None, name
        g, r = p.grad.numpy() * scale, want[name].numpy()
        # ~1e-5 relative per tensor measured; tensors whose true gradient
        # is 0 (a bias before a batch-statistics BN, a key bias under the
        # softmax) hold rounding noise of ~1e-9, inside the atol
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-5 * gmax,
                                   err_msg=name)

    # after the step: batch statistics (forward only) tightly; parameters
    # wherever Adam's first step is determined, i.e. where the two
    # gradients agree in sign and stand clear of its eps (1e-8). Elsewhere
    # the step is +-lr: a sign flip of a rounding-level gradient moves it
    # by at most 2 lr, for a few elements only.
    lr0 = lr_max / 10.0
    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    sd = det.module.state_dict()
    assert sorted(after) == sorted(sd)
    n_loose = n_all = 0
    for k, r in after.items():
        got, r = sd[k].numpy(), r.numpy()
        if k not in params:
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        g, gr = params[k].grad.numpy(), want[k].numpy()
        firm = (np.sign(g) == np.sign(gr)) & (np.abs(gr) > 1e-6)
        np.testing.assert_allclose(got[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        assert np.all(np.abs(got - r) <= 2 * lr0 * 1.01 + 1e-6), k
        n_loose += int((~firm).sum())
        n_all += firm.size
    assert n_loose <= 0.01 * n_all
