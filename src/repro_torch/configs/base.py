"""Architecture configuration + registry for the assigned model pool."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoECfg:
    num_experts: int  # routed experts
    top_k: int
    num_shared: int = 0  # shared (always-on) experts
    d_ff_expert: int = 0  # per-expert hidden (0 -> arch d_ff)
    every: int = 1  # MoE on layers where (l % every == offset)
    offset: int = 0
    first_k_dense: int = 0  # leading dense layers (deepseek-moe style)
    capacity_factor: float = 1.25
    pad_to: int = 0  # pad expert count for even sharding (0 = none)

    @property
    def padded_experts(self) -> int:
        return max(self.num_experts, self.pad_to)


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 64  # scan chunk (checkpoint boundary)


@dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk: int = 32


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: MoECfg | None = None
    mamba: MambaCfg | None = None
    rwkv: RWKVCfg | None = None
    # repeating unit of mixer kinds; tiled to num_layers
    block_pattern: tuple[str, ...] = ("attn",)
    # input modality: "tokens" or "embeddings" (audio/vlm frontend stubs)
    input_kind: str = "tokens"
    subquadratic: bool = False  # can run long_500k
    source: str = ""  # provenance note

    def __post_init__(self):
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} not a multiple of "
            f"pattern {len(self.block_pattern)}"
        )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def mixer_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        if self.moe is None:
            return False
        if layer < self.moe.first_k_dense:
            return False
        return layer % self.moe.every == self.moe.offset

    @property
    def scan_unit(self) -> int:
        """Layers per scan step: the repeating unit that is homogeneous in
        both mixer kind and MoE placement."""
        unit = len(self.block_pattern)
        if self.moe is not None:
            import math

            unit = unit * self.moe.every // math.gcd(unit, self.moe.every)
        return unit

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test configuration of the same family (small everything)."""
        small: dict = dict(
            num_layers=self.scan_unit * 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                num_shared=min(self.moe.num_shared, 1),
                d_ff_expert=32,
                pad_to=0,
            )
        if self.mamba is not None:
            small["mamba"] = dataclasses.replace(self.mamba, d_state=8, chunk=8)
        if self.rwkv is not None:
            small["rwkv"] = dataclasses.replace(
                self.rwkv, head_dim=16, decay_lora=8, mix_lora=8, chunk=8
            )
            small["num_heads"] = 4
        small.update(overrides)
        return dataclasses.replace(self, **small)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        from . import _load_all

        _load_all()
    return _REGISTRY[name]


def all_archs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
