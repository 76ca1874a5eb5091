"""Hopper kernels and their wrappers.

`montmul` (K1, K5) and `montexp` (K2, K3, K4, K6, K7) hold each kernel's
wrapper beside its plain PyTorch version; `build` compiles `csrc/*.cu`
with nvcc at first use; `ops` gives the limb-level contracts the engine
calls.
"""
