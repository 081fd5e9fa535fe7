"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]

Block unit (8 layers): attention at index 4, Mamba elsewhere; MoE FFN on odd
layers.  scan_unit = lcm(8, 2) = 8."""
from .base import ArchConfig, MambaCfg, MoECfg, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    moe=MoECfg(num_experts=16, top_k=2, every=2, offset=1, capacity_factor=1.25),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2, chunk=64),
    subquadratic=True,     # Mamba-dominant; 9 attn layers use sharded KV
    source="arXiv:2403.19887",
))
