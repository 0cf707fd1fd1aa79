"""joinbench: the benchmark of the PyTorch and CUDA port
(``distributed_join_tpu_torch``).

``python3 joinbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything the yardstick depends on lives here: the traffic, the
frozen generators, the plain reference, the bound arithmetic and the
metric readers. From the port it takes only the system under test and
its spans and kernel names.
"""
