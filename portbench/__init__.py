"""The benchmark of ``partner_tpu_torch`` on one NVIDIA H100: one cell
(a configuration under a traffic mix) a run, driven by ``BENCHMARK.json``
at the checkout's root (``python3 portbench/run.py --workload CELL --seed
N --seconds S --trace 0|1``)."""
