"""The benchmark of ``repro_torch``'s LM serving on one H100.

Run one cell once from the repository root::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it (:mod:`portbench.spec`).
"""
