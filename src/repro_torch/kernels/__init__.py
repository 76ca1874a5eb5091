"""Hopper kernels of the RNS pipeline and their wrappers.

`montmul` (K1), `montexp` (K2, K3) hold each kernel's wrapper beside its
plain PyTorch version; `build` compiles `csrc/*.cu` with nvcc at first
use; `ops` gives the limb-level contracts the engine calls.
"""
