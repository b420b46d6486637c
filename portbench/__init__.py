"""The benchmark of ``orama_core_tpu_torch``'s served read path.

Run one cell from the root of a checkout:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel roofline sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it (``portbench/spec.py``).
"""
