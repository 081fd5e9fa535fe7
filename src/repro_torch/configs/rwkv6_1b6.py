"""rwkv6-1.6b — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from .base import ArchConfig, RWKVCfg, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # 2048 / head_dim 64
    num_kv_heads=32,       # unused (attention-free)
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv=RWKVCfg(head_dim=64, decay_lora=64, mix_lora=32, chunk=32),
    subquadratic=True,     # O(1) state: long_500k native
    source="arXiv:2404.05892",
))
