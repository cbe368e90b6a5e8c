"""The benchmark's frame, the same for every cell: it finds a cell's files
by the names in ``BENCHMARK.json`` (``configs/<config>.json``,
``traffic/<traffic>.json``, ``mixes/<mix>.py``, ``metrics/<metric>.py``),
times set-up, builds the program's detector with seeded weights, and
prints the result line. What is particular to a traffic mix lives in its
``mixes/`` file; what is particular to a per-layer metric, in its
``metrics/`` file."""

import contextlib
import copy
import importlib.util
import json
import os
import subprocess
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# no module of these top-level names may be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "partner_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_code(kind, name, base=BENCH_DIR):
    """The module in ``<base>/<kind>/<name>.py``."""
    path = os.path.join(base, kind, name + ".py")
    if not os.path.exists(path):
        raise LookupError(f"no {kind} file {path}")
    mod_name = "portbench_" + "_".join(
        "".join(c if c.isalnum() else "_" for c in s) for s in (kind, name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names loaded: its
    configuration file, its traffic file and that file's mix, and the
    end-to-end and per-layer metrics it reports."""

    def __init__(self, bench, name, root=ROOT, base=BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise LookupError(f"no cell {name!r}; cells: {sorted(cells)}")
        w = cells[name]
        self.name, self.chips = name, int(w["chips"])
        entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.config_name = entry["name"]
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic_name = w["traffic"]
        self.traffic = load_json(os.path.join(base, "traffic",
                                              w["traffic"] + ".json"))
        self.mix = load_code("mixes", self.traffic["mix"], base)
        self.base = base
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]

    def reader(self, metric):
        return load_code("metrics", metric, self.base)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root=ROOT):
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds. The port's own nvcc build caches
    in ``partner_tpu_torch/.build/``, inside the checkout as well."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # a library that could load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def gpu_readings():
    """nvidia-smi's name, power limit, SM clock, power draw and
    temperature of card 0, as one line, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit,"
             "clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip() or None


def host_share(process_s, window_s):
    """One line on the host's CPU over the window: this process's CPU
    seconds a second of it."""
    return (f"host: {os.cpu_count()} cores; this process "
            f"{process_s / window_s:.2f} CPU s a second")


class Setup:
    """Set-up time from the process's start, split into named parts."""

    def __init__(self, t0):
        self.t0 = t0
        self.parts = {}

    @contextlib.contextmanager
    def part(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + (
                time.perf_counter() - start)


class Run:
    """One run of a cell: its seed, window length, trace switch, device
    and set-up clock."""

    def __init__(self, cell, seed, seconds, trace, device, t0):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.config, self.traffic = cell.config, cell.traffic
        self.setup = Setup(t0)

    def rng(self, stream):
        from . import inputs

        return inputs.rng_for(self.seed, stream)


def build_program(cfg, device, seed):
    """The program's detector of configuration ``cfg`` on ``device`` in
    eval mode, with the seeded weights of :mod:`weights`."""
    from partner_tpu_torch.models import build_detector

    det = build_detector(copy.deepcopy(cfg["model"]),
                         copy.deepcopy(cfg["train_cfg"]),
                         copy.deepcopy(cfg["test_cfg"]), device="meta")
    det.module.to_empty(device=device)
    det.module.load_state_dict(seeded_state(cfg, seed, device))
    det.module.eval()
    return det


def seeded_state(cfg, seed, device):
    """The seeded weights of configuration ``cfg`` (:mod:`weights`), by
    parameter and buffer name, on ``device``."""
    from . import reference, weights

    return weights.draw(reference.build(cfg, "meta").module, seed, device)


def build_reference(cfg, device, seed, dtype="float32"):
    """The reference detector of ``cfg`` on ``device`` with the same
    seeded weights (:func:`reference.build`'s ``dtype``)."""
    from . import reference, weights

    det = reference.build(cfg, device, dtype)
    det.module.load_state_dict(weights.draw(det.module, seed, device))
    return det


def device_info(device, chips):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def traced_device(device, trace):
    """Puts a traced run's busy seconds and slice length into ``device``;
    -> the result line's ``breakdown``, or None without a trace."""
    if not trace:
        return None
    if trace["busy_s"] is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
    return {"device_ops": trace["device_ops"],
            "idle_gaps": trace["idle_gaps"]}


class Outcome:
    """What a mix hands back: end-to-end values by name, the records the
    per-layer readers read, the requests attempted and failed, the numbers
    compared for ``correct`` as [(name, value, limit)], the device's
    readings and the profiled slice's breakdown."""

    def __init__(self, e2e, records, attempted, failed, checks, device,
                 breakdown=None):
        self.e2e, self.records = e2e, records
        self.attempted, self.failed = attempted, failed
        self.checks, self.device, self.breakdown = checks, device, breakdown


def result_line(run, out):
    """The contract's last line: with ``--trace 0`` the cell's end-to-end
    metrics, with ``--trace 1`` its per-layer metrics that found
    something to read; ``checks`` comes last."""
    cell = run.cell
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(out.records)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": all(v <= lim for _, v, lim in out.checks)
            and out.failed == 0 and bool(out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": out.device}
    if run.trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {n: {"value": float(v), "limit": float(lim)}
                      for n, v, lim in out.checks}
    return line


def finish(run, out):
    """Prints the result (0), or no result when a forbidden module was
    loaded (5)."""
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 5
    line = result_line(run, out)
    for name, v, lim in out.checks:
        log(f"check {name}: {v!r} (limit {lim!r})")
    print(json.dumps(line), flush=True)
    return 0
