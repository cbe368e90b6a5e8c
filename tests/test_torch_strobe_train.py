"""One float32 train step of STROBE and of HAN 4-sector in
partner_tpu_torch against ``jax.jit(make_train_step)`` (CPU).

Each config cut as ``torch_port_fixtures.tiny_strobe_cfg`` cuts it, one
drawn, randomized flax tree, a train batch of two samples of a synthetic
nuScenes set with lidarseg files through the config's pipeline in the
port (3 sweeps a sample; HAN 4-sector's targets assigned on its 4 cuboid
sectors, as the train CLI assigns them). STROBE takes the batch split into
its last 2 sweeps a sample (``chip_smoke.sweep_split``: no loader builds
its (B, S, P, C) batch), the targets and the points' labels of the key
frame. Held by the rules of ``tests/test_torch_seg.py``'s
``_step_against_jax`` (those of ``tests/test_torch_nusc_train.py``):
the loss terms at 1e-5, the gradient norm within 1e-5 or 3x the
reference's own spread under a four-ulp weight move, each gradient within
``GRAD_RMS`` relative RMS (``OUT_RMS`` at the output convs) or 3x that
spread, the BatchNorm statistics at 1e-5 after every chained update (each
sweep's and sector's), the parameters within 2 lr of the start and at
2e-6 where Adam's first step is determined.

At these random weights a train-mode ReLU input can lie within rounding
of 0: the two packages then take opposite sides of its kink, and every
gradient upstream of it jumps by a piece (measured: one input of -5.6e-7
in HAN 4-sector's deepest neck block, 4 x 4 x 32 at batch 2, moves
``neck.block2_bn0.bias``'s gradient by 1.8% and ``lstm.hg.weight``'s by
1.6%; one of 1.2e-6 in STROBE's neck moves ``neck.block1_bn0.bias``'s by
4.3%). ``_step_against_jax(..., kinks=True)`` then holds the port's step
with one such input on its other side, at every bound above.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_seg import _step_against_jax
from torch_port_fixtures import (STROBE_HAN_CONFIGS, drawn_init, nusc_batch,
                                 randomize, tiny_strobe_cfg,
                                 write_tiny_nusc_set)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("strobe_train"))
    return root, write_tiny_nusc_set(root, seed=16, lidarseg=True)


@pytest.mark.parametrize("name", ["strobe-1", "han-4"])
def test_train_step_matches_jax(scene, name):
    """The step's metrics: per-task lists ``det_loss``, ``hm_loss``,
    ``loc_loss`` (STROBE's ``CenterPointDetector``) or ``sector{s}_loss``
    (HAN's ``PolarStreamDetector``), ``seg_loss``, ``loss`` and
    ``grad_norm``; the targets (2, 16, 16, 10) or (2, 4, 8, 8, 10)."""
    from partner_tpu.models import build_detector as jax_build
    from partner_tpu_torch.models import build_detector

    sys.path.insert(0, ROOT)
    import chip_smoke

    root, info = scene
    config = STROBE_HAN_CONFIGS[name]
    m, tc = tiny_strobe_cfg(config)
    tdet = build_detector(m, None, tc, device="cpu")
    n_sec = getattr(tdet.module, "n_sectors", 1)
    batch = nusc_batch(config, m, info, root, "train", 2, seed=5,
                       n_sectors=n_sec)
    if tdet.input_kind == "sweeps":
        batch = chip_smoke.sweep_split(batch, 2)
    ex = {k: batch[k] for k in tdet.loss_keys}
    assert ex["hm"][0].shape == ((2, 16, 16, 10) if n_sec == 1
                                 else (2, 4, 8, 8, 10))
    assert ex["points"].ndim == (4 if name.startswith("strobe") else 3)
    assert int((ex["points_label"] > 0).sum()) > 500
    jdet = jax_build(m, None, tc)
    rng = np.random.RandomState(17)
    v = randomize(drawn_init(jdet.module.init, rng, {
        k: ex[k] for k in ("points", "points_mask")}, train=False), rng)
    met = _step_against_jax(jdet, tdet, v, ex, kinks=True)
    want = (["det_loss", "hm_loss", "loc_loss"] if n_sec == 1 else
            [f"sector{s}_loss" for s in range(4)])
    assert sorted(met) == sorted(want + ["grad_norm", "loss", "seg_loss"])
