"""The result line's schema, run through the harness's own code at a tiny
size on the CPU (the look for a card skipped), and what a run prints and
exits with where no card is."""

import json
import math
import os
import subprocess
import sys

import pytest

import portbench_tiny as tiny
from portbench import harness

CELLS = ["partner-serve-b1", "centerpoint-serve-b1"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(cell, trace):
    run = tiny.tiny_run(cell, seed=2 ** 33 + 5, seconds=1.5, trace=trace)
    out = run.cell.mix.run(run)
    line = json.loads(json.dumps(harness.result_line(run, out)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert line["failed"] == 0
    want = ({m["name"] for m in run.cell.per_layer} if trace
            else {m["name"] for m in run.cell.end_to_end})
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(line.get("breakdown", {})) <= {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_run_loads_nothing_of_jax():
    """What ``run.py`` loads for a cell, driven to its end at the tiny
    size: no top-level module, compared whole, of JAX or the JAX
    package (``partner_tpu_torch`` is not ``partner_tpu``)."""
    code = (
        "import sys, json; sys.path.insert(0, 'portbench/tests');"
        "import portbench.run, portbench_tiny as t;"
        "from portbench import harness, calibrate;"
        "r = t.tiny_run(%r, seconds=0.3, trace=1);"
        "out = r.cell.mix.run(r); harness.result_line(r, out);"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        % CELLS[0])
    res = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "partner_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("partner_tpu_torch_probe_x", sys)
    try:
        assert "partner_tpu_torch_probe_x" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("partner_tpu_torch_probe_x", None)
