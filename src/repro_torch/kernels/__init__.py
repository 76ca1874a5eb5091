"""Hopper kernels and their wrappers.

`montmul` (K1, K5), `montexp` (K2, K3, K4, K6, K7) and `ring_matmul`
(K8) hold each kernel's wrapper beside its plain PyTorch version;
`build` compiles `csrc/*.cu` with nvcc at first use; `ops` gives the
limb-level and R64 contracts the engine and the benchmark call.
"""
