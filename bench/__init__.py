"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once and prints one JSON line.  Everything that
belongs to one configuration, cell or per-layer metric is a file of its
own (``configs/``, ``workloads/``, ``metrics/``), found by the name in
``BENCHMARK.json``; see ``README.md``.
"""
