"""The frozen arithmetic: each configuration's dense FLOPs a frame
recounted over the reference, the sparse convs' FLOPs by active pairs
against a count of the pairs from the coordinates alone, and the MFU
arithmetic."""

import numpy as np
import pytest
import torch

import portbench_tiny as tiny
from portbench import harness, inputs, reference, yardstick


@pytest.mark.parametrize("config", ["partner", "centerpoint"])
def test_dense_flops_recounted(config):
    cfg = harness.load_json(f"{tiny.ROOT}/portbench/configs/{config}.json")
    assert reference.frame_flops_dense(cfg) == cfg["flops"]["frame_dense"]


def _pairs(coords, shape, kernel, stride, padding, out_coords):
    """(output site, active input site) pairs of a conv, by brute force
    over the kernel's offsets."""
    have = {tuple(c) for c in coords}
    n = 0
    for o in out_coords:
        for dz in range(kernel[0]):
            for dy in range(kernel[1]):
                for dx in range(kernel[2]):
                    i = (o[0] * stride[0] - padding[0] + dz,
                         o[1] * stride[1] - padding[1] + dy,
                         o[2] * stride[2] - padding[2] + dx)
                    n += i in have
    return n


def _sites(coords, shape, kernel, stride, padding):
    out = set()
    for c in coords:
        ranges = []
        for d in range(3):
            lo = -((-(c[d] + padding[d] - kernel[d] + 1)) // stride[d])
            hi = (c[d] + padding[d]) // stride[d]
            n_out = (shape[d] + 2 * padding[d] - kernel[d]) // stride[d] + 1
            ranges.append(range(max(lo, 0), min(hi, n_out - 1) + 1))
        out |= {(z, y, x) for z in ranges[0] for y in ranges[1]
                for x in ranges[2]}
    return sorted(out)


@pytest.mark.parametrize("config", ["partner", "centerpoint"])
def test_sparse_flops_count_active_pairs(config):
    from portbench.reference.ptt.ops.voxelize import DeviceVoxelizer

    cfg = tiny.tiny_config(harness.load_json(
        f"{tiny.ROOT}/portbench/configs/{config}.json"))
    vg = cfg["model"]["bbox_head"]["voxel_generator"]
    c = cfg["model"]["backbone"]["num_input_features"]
    pts, mask, _ = inputs.serve_sweep(inputs.rng_for(4, "f"), vg, 600, 800,
                                      4, c)
    det = harness.build_reference(cfg, "cpu", 3)
    bb, grid = det.module.backbone, det.module.grid_size
    vox = DeviceVoxelizer(vg, "cpu", reference.serving_capacity(vg))(
        torch.from_numpy(pts), torch.from_numpy(mask))
    got = yardstick.sparse_flops(bb, vox, grid)

    shape = bb.sparse_shape(grid)
    coords = [tuple(int(v) for v in r)
              for r in vox["coords"][0][vox["voxel_mask"][0]]]
    subm = _pairs(coords, shape, (3, 3, 3), (1, 1, 1), (1, 1, 1), coords)
    want = subm * 2 * (c * 16 + 4 * 16 * 16)
    cin = 16
    for name, cout in (("conv2", 32), ("conv3", 64), ("conv4", 128),
                       ("extra_conv", 128)):
        st = getattr(bb, name)
        geom = (tuple(np.broadcast_to(st.kernel, 3)),
                tuple(np.broadcast_to(st.stride, 3)),
                tuple(np.broadcast_to(st.padding, 3)))
        out = _sites(coords, shape, *geom)
        want += _pairs(coords, shape, *geom, out) * 2 * cin * cout
        shape = tuple((shape[d] + 2 * geom[2][d] - geom[0][d]) // geom[1][d]
                      + 1 for d in range(3))
        coords = out
        if st.num_res:
            want += _pairs(coords, shape, (3, 3, 3), (1, 1, 1), (1, 1, 1),
                           coords) * 2 * cout * cout * 4
        cin = cout
    assert got == want


def test_mfu():
    assert yardstick.mfu(989e12 * 0.5, 1.0) == pytest.approx(50.0)
    assert yardstick.mfu(989e9, 0.1) == pytest.approx(1.0)
