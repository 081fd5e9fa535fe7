"""qwen1.5-4b — dense, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
))
