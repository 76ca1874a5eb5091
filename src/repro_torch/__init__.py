"""PyTorch/CUDA port of the EFMVFL system (import name ``repro_torch``).

Same layout as the JAX package it mirrors (`crypto/`, `mpc/`, `core/`,
`runtime/`, `checkpoint/`, `serve/`, `kernels/`, `data/`), plus
`bench/`, the benchmarks.  Ring shares and ciphertext limbs are torch
tensors on an explicit ``device``; party float math, Paillier keygen and
the numpy randomness streams stay on the host.  The eight kernels (K1–K8) are
hand-written CUDA (`csrc/`), built with ``nvcc`` at first use and loaded
through ``ctypes``.
"""
