"""One run of each cell on the card, through ``portbench/run.py`` as the
check runs it, at a window of 15 s (long enough to serve the frames the
check draws among the first 48): exit 0, ``correct`` true, the contract's
keys and the cell's metrics. Needs an NVIDIA card; skips here without
one (run on the card: ``python -m pytest -m cuda portbench/tests``)."""

import json
import subprocess
import sys

import pytest

import portbench_tiny as tiny
from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 17), "--seconds", "15", "--trace", str(trace)],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    c = harness.Cell(harness.benchmark(), cell)
    names = ({m["name"] for m in c.per_layer} if trace
             else {m["name"] for m in c.end_to_end})
    assert set(line["metrics"]) == names
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]
