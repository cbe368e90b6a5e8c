"""The frozen reference against the port's plain path at a tiny size on
the CPU: in float32 both compute every stage of a frame alike, and the
decode + NMS keep the same detections."""

import pytest
import torch

import portbench_tiny as tiny
from portbench import check, harness, inputs, reference


def _sweep(cfg, seed):
    vg = cfg["model"]["bbox_head"]["voxel_generator"]
    c = cfg["model"]["backbone"]["num_input_features"]
    pts, mask, _ = inputs.serve_sweep(inputs.rng_for(seed, "t"), vg, 3000,
                                      3600, 8, c)
    return torch.from_numpy(pts), torch.from_numpy(mask)


@pytest.mark.parametrize("config", ["partner", "centerpoint"])
def test_reference_frame_matches_port_plain_path(config):
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    from portbench.reference.ptt.ops.voxelize import DeviceVoxelizer as Ref

    cfg = tiny.tiny_config(harness.load_json(
        f"{tiny.ROOT}/portbench/configs/{config}.json"))
    vg = cfg["model"]["bbox_head"]["voxel_generator"]
    cap = reference.serving_capacity(vg)
    pts, mask = _sweep(cfg, 5)
    vox = DeviceVoxelizer(vg, "cpu", cap)(pts, mask)
    assert check.rel_err(vox, Ref(vg, "cpu", cap)(pts, mask)) == 0.0
    ex = {"points": pts, "points_mask": mask, **vox}
    prog = harness.build_program(cfg, "cpu", 123)
    ref = harness.build_reference(cfg, "cpu", 123)
    with torch.no_grad():
        got, want = prog.module(ex), ref.module(ex)
        assert check.rel_err(got, want) <= 1e-6
        out, ref_out = prog.decode(got), ref.decode(want)
    assert int(out["mask"].sum()) > 0
    assert check.det_mismatch(out, ref_out) == 0


@pytest.mark.parametrize("config", ["partner", "centerpoint"])
def test_seeded_weights_fill_every_leaf(config):
    cfg = tiny.tiny_config(harness.load_json(
        f"{tiny.ROOT}/portbench/configs/{config}.json"))
    det = harness.build_program(cfg, "cpu", 9)
    again = harness.build_program(cfg, "cpu", 9)
    other = harness.build_program(cfg, "cpu", 10)
    a, b, c = (d.module.state_dict() for d in (det, again, other))
    assert set(a) == set(b)
    for k in a:
        assert torch.isfinite(a[k]).all()
        assert torch.equal(a[k], b[k]), k
    drawn = [k for k in a if a[k].numel() > 1 and a[k].std() > 0]
    assert drawn and all(not torch.equal(a[k], c[k]) for k in drawn)


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import portbench.reference,"
            " portbench.reference.ptt.ops.voxelize, portbench.weights,"
            " portbench.check, portbench.inputs, portbench.yardstick;"
            " print(sorted({m.split('.')[0] for m in sys.modules}))"
            % tiny.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    for name in ("partner_tpu_torch", "partner_tpu", "jax", "flax"):
        assert f"'{name}'" not in out


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -9,
                      1.0 + 3 * 2 ** -12])
    got = reference.tf32(x)
    assert torch.equal(got, torch.tensor([1.0, 1.0 + 2 ** -10,
                                          1.0 + 2 ** -10, -3.0 - 2 ** -9,
                                          1.0 + 2 ** -10]))
