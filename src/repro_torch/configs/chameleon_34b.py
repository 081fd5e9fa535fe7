"""chameleon-34b — early-fusion VQ image tokens; the vision frontend is a
stub (input_specs provides precomputed patch-token embeddings); qk-norm per
the paper. [arXiv:2405.09818; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    input_kind="embeddings",
    source="arXiv:2405.09818",
))
