"""``BENCHMARK.json`` against the rules of its format: names, units and
texts in their characters and lengths, each entry with its keys, bounds
in range, every name found as a file, and every cell reporting
``setup_s``, another end-to-end metric and a per-layer metric."""

import os
import re

import portbench_tiny as tiny
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _check(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(
            c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(tiny.ROOT, c["file"]))
    configs = {c["name"] for c in bench["configs"]}
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _text(w["why"])
        assert os.path.exists(os.path.join(
            tiny.ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        cells.add(w["name"])
    assert configs == {w["config"] for w in bench["workloads"]}
    e2e = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert _text(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", e2e[m["moves"]])) <= e2e[m["moves"]]
        assert os.path.exists(os.path.join(
            tiny.ROOT, "portbench", "metrics", m["name"] + ".py"))
        for c in m.get("workloads", e2e[m["moves"]]):
            layers.setdefault(c, set()).add(m["name"])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for c in cells:
        assert sum(c in w for w in e2e.values()) >= 2 and layers.get(c)


def test_benchmark_json_keeps_its_format():
    _check(harness.benchmark())
