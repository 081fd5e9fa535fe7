"""Hand-written CUDA kernels for the perf-critical compute layers.

  gather_distance.py  fused candidate gather + dequant + query dot + squared
                      norm (WoW candidate fetch); source
                      ``repro_torch/csrc/gather_norm_dot.cu``

``ops.py`` holds the dispatch wrappers (CUDA kernel for CUDA tensors, plain
torch for CPU tensors); ``ref.py`` holds the plain torch versions the tests
and ``chip_smoke.py`` hold the kernels against; ``_build.py`` compiles the
CUDA sources with ``nvcc`` at first use and binds them with ctypes.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
