"""Benchmark of the PyTorch/CUDA port of EFMVFL (`repro_torch`).

`python3 -m vflbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line.  This package imports nothing of the JAX package.
"""
