"""The static-RPE cache: partner_tpu_torch against the JAX package.

On the tiny flagship config (float32; block 0 unshifted, block 1 shifted),
``E2EDetector.prepare_inference`` on both sides: the port's tables equal
JAX's ``rpe_cache``, its warmed ``predict`` equals JAX's warmed ``predict``,
and on the port warmed equals live (as ``tests/test_detector.py`` holds
JAX) while the ``state_dict`` keeps its keys.
"""

import numpy as np
import pytest
import torch

from torch_port_fixtures import (load_converted, randomize, synthetic_points,
                                 tiny_frame_cfg)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def warmed():
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    rng = np.random.RandomState(3)
    model_cfg, test_cfg = tiny_frame_cfg()
    pc_range = model_cfg["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_points(rng, pc_range, 2000, 2400)
    ex = {"points": pts, "points_mask": mask}
    jdet = jax_build(model_cfg, None, test_cfg)
    v = randomize(jdet.init(jax.random.PRNGKey(0), {
        "points": pts[:, :64], "points_mask": mask[:, :64]}), rng)
    jwarm = jdet.prepare_inference(v, ex)
    jtables = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(t)
        for path, t in jax.tree_util.tree_flatten_with_path(
            jwarm["rpe_cache"])[0]}
    jout = {k: np.asarray(x) for k, x in jax.jit(jdet.predict)(
        jwarm, ex).items()}

    tdet = build_detector(model_cfg, None, test_cfg, device="cpu")
    load_converted(tdet.module, v)
    tex = {k: torch.from_numpy(a) for k, a in ex.items()}
    keys = sorted(tdet.module.state_dict())
    live = tdet.predict(tex)
    ttables = tdet.prepare_inference(tex)
    warm = tdet.predict(tex)
    return dict(jtables=jtables, jout=jout, tdet=tdet, tex=tex, keys=keys,
                live=live, ttables=ttables, warm=warm)


def test_tables_match_jax(warmed):
    jt, tt = warmed["jtables"], warmed["ttables"]
    assert len(tt) == len(jt) == 2
    for name, table in tt.items():
        block = name.split(".")[-2]                   # block0, block1
        (jname,) = [k for k in jt if f"/{block}/" in k]
        want = jt[jname]
        assert tuple(table.shape) == want.shape == (8, 4, 64, 64)
        # float32 to 1e-6 of the table's scale, by RMS and elementwise: u =
        # pos @ W0 reaches tens and u_i - u_j cancels, so a rounding of u
        # (XLA fuses the 2-term dot, the port does not) moves an entry by
        # ~1e-5, and the shifted block's -100 mask terms hold entries of
        # ~100 (measured: 4e-8 / 8e-8 RMS, max 3e-5 / 8e-6)
        err = table.numpy() - want
        scale = np.abs(want).max()
        assert np.linalg.norm(err) <= 1e-6 * np.linalg.norm(want), name
        assert np.abs(err).max() <= 1e-6 * scale, name


def test_warmed_predict_matches_jax(warmed):
    jout = warmed["jout"]
    tout = {k: x.numpy() for k, x in warmed["warm"].items()}
    assert tout["mask"].sum() > 10
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    m = jout["mask"]
    # 1e-5, relative where boxes reach ~75 m (a float32 ulp there is 8e-6)
    np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout["box3d_lidar"][m],
                               jout["box3d_lidar"][m], rtol=1e-5, atol=1e-5)


def test_warmed_matches_live(warmed):
    live, warm = warmed["live"], warmed["warm"]
    torch.testing.assert_close(warm["mask"], live["mask"], rtol=0, atol=0)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(warm[k].numpy(), live[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_cache_stays_out_of_the_state_dict(warmed):
    tdet = warmed["tdet"]
    assert sorted(tdet.module.state_dict()) == warmed["keys"]
    # clear_inference_cache drops the tables
    assert all(m.rpe_table is not None
               for m in tdet._window_attentions().values())
    tdet.clear_inference_cache()
    assert all(m.rpe_table is None
               for m in tdet._window_attentions().values())
    again = tdet.predict(warmed["tex"])
    for k, x in warmed["live"].items():
        torch.testing.assert_close(again[k], x, rtol=0, atol=0)


@pytest.mark.parametrize("change", ["load_state_dict", "train_step"])
def test_new_weights_drop_the_tables(change):
    """A detector warmed on one set of weights and then given another (by
    ``load_state_dict``, or by train mode and an in-place step as an
    optimizer makes it) predicts as a live detector of the new weights:
    the old table is not read."""
    from partner_tpu_torch.models import build_detector

    model_cfg, test_cfg = tiny_frame_cfg()
    pc_range = model_cfg["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_points(np.random.RandomState(5), pc_range, 2000,
                                 2400)
    ex = {"points": torch.from_numpy(pts),
          "points_mask": torch.from_numpy(mask)}
    old, new = (build_detector(model_cfg, None, test_cfg, device="cpu",
                               generator=torch.Generator().manual_seed(s))
                for s in (1, 2))
    want = new.predict(ex)
    assert old.prepare_inference(ex)
    if change == "load_state_dict":
        old.module.load_state_dict(new.module.state_dict())
    else:
        old.module.train()
        with torch.no_grad():
            for p, q in zip(old.module.parameters(), new.module.parameters()):
                p.copy_(q)
    assert all(m.rpe_table is None
               for m in old._window_attentions().values())
    got = old.predict(ex)
    for k, x in want.items():
        torch.testing.assert_close(got[k], x, rtol=0, atol=0)
