"""One run of one benchmark cell:

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the cell's metrics as one JSON line,
the last line of standard output; the numbers compared for ``correct``,
each beside its limit, are the last lines of standard error. Exits non-zero
without a result when the cell needs more CUDA cards than there are, or
when a module of JAX or of the JAX package was loaded."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = harness.Cell(harness.benchmark(), a.workload)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        harness.log(f"{cell.name} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count()}")
        return 3
    run = harness.Run(cell, a.seed, a.seconds, a.trace,
                      torch.device("cuda", 0), T0)
    return harness.finish(run, cell.mix.run(run))


if __name__ == "__main__":
    sys.exit(main())
