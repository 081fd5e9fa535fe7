"""Hand-written CUDA kernels for the perf-critical compute layers.

  gather_distance.py  fused candidate gather + dequant + query dot + squared
                      norm (WoW candidate fetch); source
                      ``repro_torch/csrc/gather_norm_dot.cu``
  distance.py         batched query-candidate dots over gathered rows (the
                      reference hop pipeline's distance stage); source
                      ``repro_torch/csrc/batched_dot.cu``
  flash_attention.py  causal GQA attention with an online softmax (the LM's
                      prefill and training attention); source
                      ``repro_torch/csrc/flash_attention.cu``
  rwkv6.py            the RWKV-6 WKV recurrence (the RWKV time mix);
                      source ``repro_torch/csrc/wkv6.cu``
  mamba_scan.py       the Mamba-1 selective scan (the Mamba mixer); source
                      ``repro_torch/csrc/mamba_scan.cu``

``ops.py`` holds the dispatch wrappers (CUDA kernel for CUDA tensors, plain
torch for CPU tensors); ``ref.py`` holds the plain torch versions the tests
and ``chip_smoke.py`` hold the kernels against; ``_build.py`` compiles the
CUDA sources with ``nvcc`` at first use and binds them with ctypes.
"""
from ..monitoring import register_counters
from . import ops, ref

__all__ = ["launch_counters", "ops", "ref"]


def launch_counters() -> tuple:
    """The ``LAUNCHES`` dict of every kernel wrapper (name -> launches), so
    a run can zero them before a path and read them after it."""
    from . import (
        distance, flash_attention, gather_distance, mamba_scan, rwkv6,
    )

    return (gather_distance.LAUNCHES, distance.LAUNCHES,
            flash_attention.LAUNCHES, rwkv6.LAUNCHES, mamba_scan.LAUNCHES)


register_counters("kernels.LAUNCHES", lambda: {
    name: n for counts in launch_counters() for name, n in counts.items()})
