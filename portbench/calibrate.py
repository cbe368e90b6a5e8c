"""The readings that each limit of ``correct`` is set from, for one cell,
in one process (set-up is paid once):

    python3 portbench/calibrate.py --workload CELL --seeds S1 S2 ... \\
        --control-seeds C1 C2 C3

For each of ``--seeds``: the cell's numbers for the program, its checked
frames served as in the window. For each of ``--control-seeds``: the same
numbers with the control in the program's place (the reference one step
below the configuration's precision, ``reference.lower_precision``), and
with each fault that the cell can have planted in the program. One JSON
line a reading; the last line sums them up: for each number the largest
sound reading (the lower) and the smallest control and fault readings."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness, probe, reference  # noqa: E402


def altered(out):
    """Detections with the first kept box moved 0.1 m in x."""
    box = out["box3d_lidar"].clone()
    first = out["mask"][0].nonzero()[:1, 0]
    box[0, first, 0] += 0.1
    return dict(out, box3d_lidar=box)


def altered_answer(det):
    """The fault "an answer altered where it is produced": every frame's
    detections :func:`altered` by the decode that makes them."""
    decode = det.decode
    det.decode = lambda *args, **kwargs: altered(decode(*args, **kwargs))
    return det


FAULTS = {"serve_closed": {"altered_answer": altered_answer}}


def readings(run, root):
    """The cell's check numbers for the served path ``root`` (the mix's
    ``served`` over a detector) serving the checked frames of ``run``'s
    seed, as in the window: {name: value}."""
    import torch

    from portbench.reference.ptt.ops.voxelize import DeviceVoxelizer

    mix = run.cell.mix
    dev, cfg = run.device, run.config
    pool = mix.make_pool(run)
    targets = mix.checked_frames(run)
    taps = probe.Taps(targets)
    taps.install(root, cfg["stages"]["serve"])
    spans = probe.Spans(dev)
    staged = [tuple(torch.from_numpy(a) for a in s) for s in pool]
    outputs = {}
    for i in targets:
        taps.frame = i
        outputs[i] = mix.serve_frame(root, *staged[i % len(staged)], dev,
                                     spans)
    taps.frame = None
    ref = mix.served(harness.build_reference(cfg, dev, run.seed),
                     DeviceVoxelizer, cfg, dev)
    return {n: v for n, v, _ in mix.judge(run, ref, targets, taps.kept,
                                          outputs)}


def program(run, plant=None):
    """The program's served path, ``plant`` (a fault) applied to its
    detector first."""
    from partner_tpu_torch.ops.voxelize import DeviceVoxelizer

    det = harness.build_program(run.config, run.device, run.seed)
    if plant is not None:
        plant(det)
    return run.cell.mix.served(det, DeviceVoxelizer, run.config, run.device)


def program_readings(run):
    return readings(run, program(run))


def control_readings(run):
    from portbench.reference.ptt.ops.voxelize import DeviceVoxelizer

    det = harness.build_reference(run.config, run.device, run.seed,
                                  dtype=None)
    return readings(run, run.cell.mix.served(
        reference.lower_precision(det), DeviceVoxelizer, run.config,
        run.device))


def fault_readings(run, fault):
    return readings(run, program(run, FAULTS[run.traffic["mix"]][fault]))


def summary(rows):
    out = {}
    for kind in ("program", "control") + tuple(
            f for fs in FAULTS.values() for f in fs):
        got = [r["readings"] for r in rows if r["kind"] == kind]
        if not got:
            continue
        agg = max if kind == "program" else min
        out[kind] = {k: agg(g[k] for g in got) for k in got[0]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    cell = harness.Cell(harness.benchmark(), a.workload)
    rows = []

    def emit(kind, seed, fn):
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, 0, 0, torch.device(a.device), t0)
        row = {"kind": kind, "seed": seed, "readings": fn(run),
               "s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if torch.device(a.device).type == "cuda":
            torch.cuda.empty_cache()

    for s in a.seeds:
        emit("program", s, program_readings)
    for s in a.control_seeds:
        emit("control", s, control_readings)
        for fault in FAULTS[cell.traffic["mix"]]:
            emit(fault, s, lambda run: fault_readings(run, fault))
    print(json.dumps({"summary": summary(rows), "cell": cell.name,
                      "card": harness.gpu_readings()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
