"""The benchmark of cuadmm_tpu_torch on one NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Everything
that belongs to one configuration, cell, per-layer metric or layer sits in
a file of its own under ``configs/``, ``workloads/``, ``metrics/`` and
``layers/``, found by the name ``BENCHMARK.json`` gives it. The yardstick
(problem generators, the plain reference, the comparison, the roofline
arithmetic and the trace reduction) lives here and imports nothing of the
program; only ``entries/`` and ``harness.py`` touch ``cuadmm_tpu_torch``.
"""
