"""The comparison that decides ``correct`` has to fail: at a tiny size on
the CPU, the control (the reference one precision step below the
configuration's) reads above a limit where the program reads below every
one, and a run driven through the harness with the timed path broken
underneath comes out not correct, once for each fault the cell can have.
On the card the same is read at the cell's own size by
``portbench/calibrate.py``."""

import pytest

import portbench_tiny as tiny
from portbench import calibrate, harness

CELLS = ["partner-serve-b1", "centerpoint-serve-b1"]
CHECK_NAMES = {"decode_nms": "det_mismatch", "sites": "sites_dropped"}


def _limits(run):
    return {CHECK_NAMES.get(k, f"rel_err.{k}"): v
            for k, v in run.config["limits"]["serve"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    run = tiny.tiny_run(cell, seed=31)
    limits = _limits(run)
    prog = calibrate.program_readings(run)
    assert all(prog[k] <= limits[k] for k in limits), (prog, limits)
    ctl = calibrate.control_readings(tiny.tiny_run(cell, seed=31))
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)


def _detector_class(cell):
    from partner_tpu_torch.models import detectors

    return (detectors.E2EDetector if cell.startswith("partner")
            else detectors.CenterPointDetector)


def _not_correct(run):
    line = harness.result_line(run, run.cell.mix.run(run))
    assert line["correct"] is False, line["checks"]
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    cls = _detector_class(cell)
    decode = cls.decode
    monkeypatch.setattr(cls, "decode", lambda self, *a, **k:
                        calibrate.altered(decode(self, *a, **k)))
    line = _not_correct(tiny.tiny_run(cell, seed=32, seconds=3.0))
    assert line["checks"]["det_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_dropped_sites_are_not_correct(cell):
    """A capacity that holds too few sites (the program and the reference
    alike drop the same, so only the count of dropped sites sees it)."""
    run = tiny.tiny_run(cell, seed=33, seconds=3.0)
    run.config["model"]["backbone"]["caps"] = [0, 2000, 2000, 1000]
    line = _not_correct(run)
    assert line["checks"]["sites_dropped"]["value"] > 0
