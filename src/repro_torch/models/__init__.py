"""LM model zoo on torch (the port of ``repro.models``): shared layers, the
dense GQA attention and RWKV-6 mixers, and the assembly in ``model.py``.
The Mamba mixer and MoE layers come with a later slice (ROADMAP A11b)."""
from .model import (
    ParamTree,
    forward,
    from_jax_params,
    init_cache,
    init_params,
    param_count,
)

__all__ = [
    "ParamTree",
    "forward",
    "from_jax_params",
    "init_cache",
    "init_params",
    "param_count",
]
