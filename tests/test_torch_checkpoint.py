"""Checkpoints: the port's own format, and JAX checkpoints read by the port.

A JAX checkpoint's ``state.pkl`` pickles optax classes in its
``opt_state``; the port reads it without importing jax, flax, optax or
anything of ``partner_tpu`` (checked in a fresh process), and the
detector it loads predicts what the JAX detector predicts.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_fixtures import randomize, synthetic_points, tiny_frame_cfg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_round_trip_through_latest(tmp_path):
    from partner_tpu_torch.train import checkpoint as ck

    wd = str(tmp_path)
    assert ck.latest_checkpoint(wd) is None
    gen = torch.Generator().manual_seed(0)
    sds = {}
    for step in (10, 20, 30):
        sds[step] = {"a.weight": torch.randn(3, 4, generator=gen),
                     "b.running_var": torch.rand(5, generator=gen)}
        ck.save_checkpoint(wd, step, sds[step], meta={"epoch": step // 10},
                           keep=2)
    assert sorted(os.listdir(wd)) == ["ckpt_00000020", "ckpt_00000030",
                                      "latest"]
    latest = ck.latest_checkpoint(wd)
    assert latest == os.path.join(wd, "ckpt_00000030")
    for path in (latest, os.path.join(wd, "latest"),
                 os.path.join(latest, "state.pt")):
        payload, meta = ck.load_checkpoint(path)
        assert payload["step"] == 30 and meta == {"epoch": 3}
        assert sorted(payload["state_dict"]) == sorted(sds[30])
        for k, v in sds[30].items():
            assert torch.equal(payload["state_dict"][k], v), k
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(os.path.join(wd, "ckpt_00000010"))


_READER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, "tests")
from partner_tpu_torch.models import build_detector
from partner_tpu_torch.train.checkpoint import load_checkpoint
from torch_port_fixtures import tiny_frame_cfg

ckpt, io = sys.argv[1], sys.argv[2]
model_cfg, test_cfg = tiny_frame_cfg()
det = build_detector(model_cfg, None, test_cfg, device="cpu")
payload, meta = load_checkpoint(ckpt)
det.module.load_state_dict(payload["state_dict"], strict=True)
ex = np.load(io + "/in.npz")
out = det.predict({k: torch.from_numpy(ex[k]) for k in ex.files})
np.savez(io + "/out.npz", **{k: v.numpy() for k, v in out.items()})
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partner_tpu")]
print(json.dumps({"bad": bad, "step": payload["step"], "meta": meta}))
"""


def test_jax_checkpoint_read_without_jax(tmp_path):
    import jax

    from partner_tpu.models import build_detector as jax_build
    from partner_tpu.train.checkpoint import save_checkpoint
    from partner_tpu.train.optim import build_one_cycle_optimizer
    from partner_tpu.train.train_state import create_train_state

    rng = np.random.RandomState(7)
    model_cfg, test_cfg = tiny_frame_cfg()
    pc_range = model_cfg["bbox_head"]["voxel_generator"]["range"]
    pts, mask = synthetic_points(rng, pc_range, 2000, 2400)
    jdet = jax_build(model_cfg, None, test_cfg)
    v = randomize(jdet.init(jax.random.PRNGKey(0), {
        "points": pts[:, :64], "points_mask": mask[:, :64]}), rng)
    state = create_train_state(v, build_one_cycle_optimizer(3e-3, 100))
    wd = str(tmp_path / "jax")
    save_checkpoint(wd, state, meta={"epoch": 0})
    with open(os.path.join(wd, "ckpt_00000000", "state.pkl"), "rb") as f:
        assert b"optax" in f.read()   # a plain pickle.load would import it
    jout = {k: np.asarray(x) for k, x in jax.jit(jdet.predict)(v, {
        "points": pts, "points_mask": mask}).items()}

    io = str(tmp_path)
    np.savez(io + "/in.npz", points=pts, points_mask=mask)
    res = subprocess.run(
        [sys.executable, "-c", _READER, os.path.join(wd, "latest"), io],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "step": 0, "meta": {"epoch": 0}}
    tout = np.load(io + "/out.npz")
    assert tout["mask"].sum() > 10
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    np.testing.assert_array_equal(tout["label_preds"], jout["label_preds"])
    m = jout["mask"]
    np.testing.assert_allclose(tout["scores"][m], jout["scores"][m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout["box3d_lidar"][m],
                               jout["box3d_lidar"][m], rtol=1e-5, atol=1e-5)
