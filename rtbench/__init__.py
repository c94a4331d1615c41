"""rtbench: the benchmark of the PyTorch and CUDA port
(``cudaraytracer_tpu_torch``).  ``python3 rtbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once and prints
one JSON line; every cell, configuration, driver and per-layer metric is
a file of its own under this folder, found by its name in
``BENCHMARK.json``."""
