"""The mesh's model axis on two gloo ranks of the CPU (``--mesh model=2``).

One launch of two ranks (``tests/torch_dist_cases.py``, ``mesh_step``)
runs one train step of the tiny flagship config with one neck scale
widened (128 filters, so that JAX's 2**16-element rule slices some
kernels: ``WIDE_SLICED`` of them) on a ``data=1, model=2`` mesh. The model
ranks hold the same batch and compute the same values, each with its
slices of the large kernels gathered where they are used, so the step
is bit-equal to the one-process step (run at the ranks' one thread: the
CPU's conv kernels split their sums by thread): the loss terms, the
gathered gradients, the parameters after Adam and the batch statistics;
the reported global norm, whose sliced leaves' squares are summed over
the model group, within ``NORM_RTOL``. Each rank's Adam slots are its
slices alone; the checkpoint of the two-rank run loads into a data-only
run and a data-only checkpoint into the two ranks. The same step is
held against JAX's ``place_train_state`` step on two virtual CPU devices
at the bounds of ``tests/test_torch_train.py`` (the rule for where
Adam's first step is determined is ``tests/test_torch_dist.py``'s for
drawn weights).
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_cases as tdc
from torch_port_fixtures import drawn_init, randomize, tiny_frame_cfg

torch.set_num_threads(2)

NORM_RTOL = 1e-6
WIDE_SLICED = 5
LR_MAX = 3e-3


def wide_tiny_cfg():
    """The tiny flagship config, drop rates 0, its second neck scale 128
    filters wide and up-sampled to 128 (head input 160)."""
    m, tc = tiny_frame_cfg()
    m["neck"] = dict(m["neck"], set_drop=0.0, set_attn_drop=0.0,
                     set_drop_path=0.0, ds_num_filters=[16, 128],
                     us_num_filters=[32, 128])
    m["bbox_head"] = dict(m["bbox_head"], in_channels=160)
    return m, tc


def _example(m):
    from test_torch_train import _step_example

    return _step_example(np.random.RandomState(0), m)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank step, the one-process step, JAX's model=2 step and the
    resume payload -> (ranks' results, one-process result, JAX's (state,
    metrics), the task)."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.parallel.mesh import make_mesh, place_train_state
    from partner_tpu.train.optim import build_one_cycle_optimizer as jax_opt
    from partner_tpu.train.train_state import create_train_state
    from partner_tpu.train.train_state import make_train_step as jax_step
    from partner_tpu_torch.convert import flax_to_torch

    m, tc = wide_tiny_cfg()
    ex = _example(m)
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(4)
    v = randomize(drawn_init(jdet.module.init, rng, {
        "points": ex["points"][:, :64],
        "points_mask": ex["points_mask"][:, :64]}, train=False), rng)
    sd = flax_to_torch(v)
    names = list(flax_to_torch({"params": v["params"]}))
    resume = {"step": 5, "state_dict": {k: t + 0.5 for k, t in sd.items()},
              "opt_state": {"count": 5, **{
                  slot: {n: torch.from_numpy(rng.randn(*sd[n].shape)
                                             .astype(np.float32))
                         for n in names} for slot in ("mu", "nu")}}}
    task = dict(kind="mesh_step", name="model2", model=m, test_cfg=tc,
                state_dict=sd, example=ex, mesh=(1, 2, 1), lr_max=LR_MAX,
                resume=resume)
    handle = tdc.start([task], str(tmp_path_factory.mktemp("model2")),
                       world=2)
    tx = jax_opt(lr_max=LR_MAX, total_steps=1000)
    mesh = make_mesh(1, 2, 1, devices=jax.devices("cpu")[:2])
    state = place_train_state(create_train_state(v, tx), mesh)
    with jax.sharding.set_mesh(mesh):
        jax_out = jax.jit(lambda s: jax_step(jdet, tx)(
            s, ex, jax.random.PRNGKey(1)))(state)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = tdc.run_mesh_step(dict(task, mesh=(1, 1, 1)), 0, 1)
    finally:
        torch.set_num_threads(threads)
    return tdc.collect(handle)["model2"], one, jax_out, task


def test_model_ranks_step_bit_equal_to_one_process(runs):
    """Both model ranks against the one-process step: the sliced tensors
    (``WIDE_SLICED``, printed), the loss terms, the gathered gradients, the
    parameters after Adam and the BatchNorm statistics bit-equal; the
    global norm within ``NORM_RTOL``."""
    ranks, one, _, _ = runs
    print("sliced over model=2:", ranks[0]["sliced"])
    assert len(ranks[0]["sliced"]) == WIDE_SLICED
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 0)]
    for r in ranks:
        assert r["sliced"] == ranks[0]["sliced"]
        got, want = dict(r["metrics"]), dict(one["metrics"])
        np.testing.assert_allclose(got.pop("grad_norm"),
                                   want.pop("grad_norm"), rtol=NORM_RTOL)
        assert got == want
        assert sorted(r["grads"]) == sorted(one["grads"])
        for k, g in one["grads"].items():
            assert torch.equal(r["grads"][k], g), k
        assert sorted(r["state"]) == sorted(one["state"])
        for k, t in one["state"].items():
            assert torch.equal(r["state"][k], t), k
        assert r["collectives"] > 0


def test_adam_slots_are_the_rank_slices(runs):
    """Each rank's Adam slot of a sliced parameter is its slice (half the
    output channels), of any other parameter the whole tensor; the
    optimizer's state gathered for a checkpoint is the one-process
    optimizer's, bit for bit."""
    from partner_tpu_torch.convert import flax_leaf

    ranks, one, _, _ = runs
    whole = one["slot_shapes"]
    for r in ranks:
        for name, shape in r["slot_shapes"].items():
            if name in r["sliced"]:
                dim = flax_leaf(name, whole[name])[2]
                assert shape[dim] * 2 == whole[name][dim], name
                assert (shape[:dim] + shape[dim + 1:]
                        == whole[name][:dim] + whole[name][dim + 1:]), name
            else:
                assert shape == whole[name], name
        for slot in ("mu", "nu"):
            for k, t in one["opt_state"][slot].items():
                assert torch.equal(r["opt_state"][slot][k], t), (slot, k)
        assert r["opt_state"]["count"] == one["opt_state"]["count"] == 1


def test_checkpoints_cross_between_model2_and_data_only(runs, tmp_path):
    """The model=2 run's checkpoint (rank 0's, slices gathered) resumes a
    data-only detector and optimizer to the one-process step's state and
    Adam slots; a data-only checkpoint resumes each model rank to its
    slices of every tensor."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    restore_train_state,
                                                    save_checkpoint)

    ranks, one, _, task = runs
    r0 = ranks[0]
    save_checkpoint(str(tmp_path), 1, r0["state"], opt_state=r0["opt_state"])
    det = build_detector(task["model"], None, task["test_cfg"], device="cpu")
    opt = tdc.optimizer(det, task)
    assert restore_train_state(det, opt, load_checkpoint(
        str(tmp_path / "latest"))[0]) == 1
    for k, t in det.module.state_dict().items():
        assert torch.equal(t, one["state"][k]), k
    names = [n for n, p in det.module.named_parameters() if p.requires_grad]
    for n, t in zip(names, opt.mu):
        assert torch.equal(t, one["opt_state"]["mu"][n]), n
    res = task["resume"]
    for idx, r in enumerate(ranks):
        assert r["resumed"]["count"] == 5
        for k, whole in res["state_dict"].items():
            got = r["resumed"]["state"][k]
            if k in r["sliced"]:
                dim = next(d for d in range(whole.dim())
                           if got.shape[d] != whole.shape[d])
                n = got.shape[dim]
                whole = whole.narrow(dim, idx * n, n)
                assert torch.equal(r["resumed"]["mu"][k], res["opt_state"][
                    "mu"][k].narrow(dim, idx * n, n)), k
            assert torch.equal(got, whole), k


def test_model2_step_matches_jax_place_train_state(runs):
    """Rank 0's step against ``jax.jit(make_train_step)`` on a state placed
    by ``place_train_state`` on ``make_mesh(1, 2, 1)`` of two virtual CPU
    devices, from the same (drawn) weights and batch, at
    ``tests/test_torch_train.py``'s bounds: loss terms and the norm at
    1e-5, ``num_matched`` equal, the gradients (the JAX step's, read back
    from Adam's first moment) at 1e-3 relative, the statistics at 1e-5,
    the parameters at 2e-6 where Adam's first step is determined and
    within 2 lr elsewhere. Where the step is determined is
    ``tests/test_torch_dist.py``'s rule for drawn weights (the clipped
    gradients agree within 1% and stand clear of ``ADAM_CLEAR``, at least
    half of the elements so): the train test's sign rule, measured at
    flax's init, leaves 1.26% of these elements undetermined against its
    1%, on the one-process port step alike (the model ranks are
    bit-equal to it)."""
    from partner_tpu_torch.convert import flax_to_torch
    from test_torch_dist import ADAM_CLEAR

    ranks, _, (new_state, jmet), _ = runs
    got = ranks[0]
    met = got["metrics"]
    assert int(met["num_matched"]) == int(jmet["num_matched"]) > 0
    for k in ("loss", "loss_ce", "loss_bbox", "loss_vote", "loss_vote_cls",
              "loss_iou", "grad_norm"):
        np.testing.assert_allclose(met[k], float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    b1 = np.float32(0.95)
    want = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) / (np.float32(1) - b1),
        new_state.opt_state.inner_state[1].mu)})
    scale = min(1.0, 35.0 / met["grad_norm"])
    assert sorted(want) == sorted(got["grads"])
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, r in want.items():
        np.testing.assert_allclose(got["grads"][name].numpy() * scale,
                                   r.numpy(), rtol=1e-3, atol=1e-5 * gmax,
                                   err_msg=name)
    after = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    assert sorted(after) == sorted(got["state"])
    lr0 = LR_MAX / 10.0
    n_firm = n_all = 0
    for k, r in after.items():
        a, r = got["state"][k].numpy(), r.numpy()
        if k not in got["grads"]:
            np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6, err_msg=k)
            continue
        g, gr = got["grads"][k].numpy() * scale, want[k].numpy()
        firm = (np.abs(gr) > ADAM_CLEAR) & (np.abs(g - gr)
                                            <= 1e-2 * np.abs(gr))
        np.testing.assert_allclose(a[firm], r[firm], rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        assert np.all(np.abs(a - r) <= 2 * lr0 * 1.01 + 1e-6), k
        n_firm += int(firm.sum())
        n_all += firm.size
    print(f"Adam's first step determined on {n_firm} of {n_all} elements")
    assert n_firm >= 0.5 * n_all
