"""deepseek-moe-16b — 2 shared + 64 routed fine-grained experts, top-6;
first layer is a dense FFN (10944 wide, per the released model).
[arXiv:2401.06066; hf]"""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,            # dense (layer-0) FFN width
    vocab_size=102400,
    head_dim=128,
    moe=MoECfg(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408,
               first_k_dense=1, capacity_factor=1.25),
    source="arXiv:2401.06066",
))
