"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]  SWA window: mistral-style 4096."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,
    subquadratic=True,     # window-bounded KV: long_500k decode is O(window)
    source="arXiv:2401.16818",
))
