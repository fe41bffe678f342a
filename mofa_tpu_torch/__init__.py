"""mofa_tpu_torch — MOFA-Video in PyTorch for NVIDIA Hopper (H100).

The second package of this repository: a port of `mofa_tpu` (JAX/TPU),
module for module, with the Pallas kernels of the main path rewritten as
CUDA C++ kernels for sm_90a (`csrc/`, bound through `ctypes`). The JAX
package is the numerical reference; `tests/test_torch_*.py` hold this
package against it on the same weights and inputs.

Public layouts follow the JAX package so tests compare like with like:
frames [B, T, H, W, C], flow [B, T-1, H, W, 2], attention [B, L, H, D].
"""
