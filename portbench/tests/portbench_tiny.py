"""Tiny cuts of the benchmark's cells for CPU tests: the configurations
on a grid of 128 range (or x) by 256 azimuth (or 128 y) by 40 z cells
with a narrow neck and head, small sparse capacities and a small NMS, and
the traffic at a few thousand points, run through the harness's own
code."""

import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TINY_GRID = {"cylinder": (128, 256, 40), "cuboid": (128, 128, 40)}


def tiny_config(cfg):
    """A configuration file's dict cut to its ``TINY_GRID``, narrow widths,
    small capacities and a small NMS, its dtypes as stated."""
    c = copy.deepcopy(cfg)
    m = c["model"]
    bh = m["bbox_head"]
    vg = bh["voxel_generator"]
    pr = vg["range"]
    grid = TINY_GRID[vg.get("voxel_shape", "cylinder")]
    vg["voxel_size"] = [(pr[3 + i] - pr[i]) / grid[i] for i in range(3)]
    vg["max_voxel_num"] = 4000
    bh["in_channels"] = 64
    m["backbone"]["caps"] = [0, 12000, 12000, 6000]
    m["neck"].update(layer_nums=[1, 1], ds_num_filters=[16, 32],
                     us_num_filters=[32, 32])
    c["test_cfg"]["nms"].update(nms_pre_max_size=256, nms_post_max_size=64)
    c["test_cfg"]["voxel_size"] = vg["voxel_size"]
    return c


TINY_SERVE = {"mix": "serve_closed", "points": 3000, "rows": 3600,
              "max_boxes": 8, "pool": 4, "warmup_frames": 2,
              "trace_frames": 2, "check_frames": 2, "check_within": 8}


def tiny_run(cell_name, seed=7, seconds=0.5, trace=0, traffic=None,
             bench=None):
    """A :class:`harness.Run` of ``cell_name`` (a cell of ``bench``,
    ``BENCHMARK.json`` by default) cut to the tiny size on the CPU (the
    harness's look for a card skipped)."""
    cell = harness.Cell(bench or harness.benchmark(), cell_name)
    cell.config = tiny_config(cell.config)
    cell.traffic = dict(traffic or TINY_SERVE)
    return harness.Run(cell, seed, seconds, trace, "cpu", time.perf_counter())
