"""The benchmark of ``kolibrie_tpu_torch`` on one H100: cells, traffic,
metric readers and the plain reference, found by name from the root's
``BENCHMARK.json``.  ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell."""
