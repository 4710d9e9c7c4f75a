"""The benchmark of polars_ols_tpu_torch on one H100 (``BENCHMARK.json``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once. Nothing here imports JAX or the JAX package.
"""
