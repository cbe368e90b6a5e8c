"""The harness finds a cell's files by the names in ``BENCHMARK.json``,
and a cell, a configuration, a traffic mix and a per-layer metric are
added by adding files and entries alone, with no edit to a file that is
already there."""

import json
import os
import shutil

import portbench_tiny as tiny
from portbench import harness


def test_every_cell_finds_its_files():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert cell.config_name == w["config"]
        assert cell.traffic_name == w["traffic"]
        assert callable(cell.mix.run)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
    names = {c["name"] for c in bench["configs"]}
    assert names == {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"


def test_adding_a_cell_is_adding_files(tmp_path):
    root = tmp_path / "checkout"
    base = root / "portbench"
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"), base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (base / p).read_bytes()
              for p in (str(q.relative_to(base))
                        for q in base.rglob("*") if q.is_file())}
    bench = harness.benchmark()
    # a configuration: a file of its own
    cfg = json.loads((base / "configs" / "partner.json").read_text())
    cfg["test_cfg"]["nms"]["nms_pre_max_size"] = 2048
    (base / "configs" / "partner_pre2048.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "partner_pre2048", "source": "x",
                             "file": "portbench/configs/partner_pre2048.json",
                             "reduced": [], "why": "x"})
    # a traffic mix: a data file, and a driver of its own
    (base / "traffic" / "burst-b1.json").write_text(json.dumps(
        {"mix": "serve_burst", "points": 10}))
    (base / "mixes" / "serve_burst.py").write_text(
        "def run(run):\n    return run.traffic['points']\n")
    # a per-layer metric: a reader of its own
    (base / "metrics" / "nms_sweeps.py").write_text(
        "def read(records):\n    return records.get('sweeps')\n")
    bench["workloads"].append({"name": "partner-burst-b1",
                               "config": "partner_pre2048",
                               "traffic": "burst-b1", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "burst_p99_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["partner-burst-b1"]})
    bench["per_layer"].append({"name": "nms_sweeps", "unit": "sweeps",
                               "better": "lower", "source": "program_counter",
                               "layer": "decode + NMS", "moves": "burst_p99_ms",
                               "workloads": ["partner-burst-b1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell(harness.benchmark(str(root)), "partner-burst-b1",
                        root=str(root), base=str(base))
    assert cell.config["test_cfg"]["nms"]["nms_pre_max_size"] == 2048
    assert cell.mix.run(type("R", (), {"traffic": cell.traffic})) == 10
    assert [m["name"] for m in cell.per_layer] == ["nms_sweeps"]
    assert cell.reader("nms_sweeps").read({"sweeps": 3}) == 3
    after = {p: (base / p).read_bytes() for p in before}
    assert after == before
