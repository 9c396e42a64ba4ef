"""nbbench: the benchmark of ``nbody3d_tpu_torch`` on one NVIDIA H100.

``python3 nbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
the cells, configurations and metrics are named in ``BENCHMARK.json``.
"""
