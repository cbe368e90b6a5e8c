"""The frozen input generators: the scene draws what the smoke script's
generator draws, seeds beyond 32 bits draw alike and apart, and a served
sweep takes its configuration's point layout."""

import numpy as np
import pytest

import portbench_tiny as tiny
from portbench import harness, inputs

POLAR = [0.3, -3.14368, -2.0, 75.18, 3.14368, 4.0]


def test_scene_equals_the_smoke_copy():
    import chip_smoke

    a = inputs.synthetic_scene(np.random.RandomState(3), POLAR, 5000, 40)
    b = chip_smoke.synthetic_scene(np.random.RandomState(3), POLAR, 5000, 40)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_seeds_beyond_32_bits_draw_alike_and_apart():
    a = inputs.rng_for(2 ** 40 + 3, "sweeps").rand(4)
    b = inputs.rng_for(2 ** 40 + 3, "sweeps").rand(4)
    c = inputs.rng_for(3, "sweeps").rand(4)
    d = inputs.rng_for(2 ** 40 + 3, "check").rand(4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)


@pytest.mark.parametrize("config", ["partner", "centerpoint"])
def test_serve_sweep_layout(config):
    cfg = harness.load_json(f"{tiny.ROOT}/portbench/configs/{config}.json")
    vg = cfg["model"]["bbox_head"]["voxel_generator"]
    c = cfg["model"]["backbone"]["num_input_features"]
    pts, mask, boxes = inputs.serve_sweep(inputs.rng_for(1, "s"), vg,
                                          180000, 216000, 40, c)
    assert pts.shape == (1, 216000, c) and mask.sum() == 180000
    assert 20 <= len(boxes) <= 40
    p = pts[0, :180000]
    r = vg["range"]
    if vg["voxel_shape"] == "cylinder":
        assert p[:, 0].min() > r[0] and p[:, 0].max() < r[3]
        assert np.allclose(np.hypot(p[:, 3], p[:, 4]), p[:, 0], atol=1e-3)
    else:
        assert np.abs(p[:, :2]).max() < r[3]
        assert np.hypot(p[:, 0], p[:, 1]).max() < r[3]
    assert (p[:, 2] >= r[2]).all() and (p[:, 2] <= r[5]).all()
