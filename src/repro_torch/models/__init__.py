"""LM model zoo on torch (the port of ``repro.models``): shared layers, the
dense GQA attention, RWKV-6 and Mamba mixers, the MoE FFN, and the
assembly in ``model.py``."""
from .model import (
    ParamTree,
    abstract_params,
    forward,
    from_jax_params,
    init_cache,
    init_params,
    loss_fn,
    param_count,
    to_jax_values,
)

__all__ = [
    "ParamTree",
    "abstract_params",
    "forward",
    "from_jax_params",
    "init_cache",
    "init_params",
    "loss_fn",
    "param_count",
    "to_jax_values",
]
