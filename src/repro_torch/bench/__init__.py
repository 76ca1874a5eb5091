"""Benchmarks of the port: `kernel_bench` (the crypto kernel rows) and
`run` (its entry point, ``python -m repro_torch.bench.run --only
kernels``, which writes ``BENCH_cuda_crypto.json``)."""
