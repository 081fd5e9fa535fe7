"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

d_ff=1408 is the per-expert width (shared tower = 4x1408 = 5632, matching the
released model).  Experts padded 60 -> 64 for even 16-way expert parallelism;
pad experts are dead weights (router never selects beyond index 59)."""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    moe=MoECfg(num_experts=60, top_k=4, num_shared=4, d_ff_expert=1408,
               pad_to=64, capacity_factor=1.25),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
