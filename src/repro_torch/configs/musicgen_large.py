"""musicgen-large — decoder-only over EnCodec tokens; the audio frontend is a
stub (input_specs provides precomputed frame embeddings).
[arXiv:2306.05284; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    input_kind="embeddings",
    source="arXiv:2306.05284",
))
