"""encbench: the benchmark of rav1e_tpu_torch on one CUDA card.

``python3 encbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.
"""
