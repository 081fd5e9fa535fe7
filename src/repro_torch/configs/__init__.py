"""The LM architecture configs, as data: a copy of ``repro.configs`` (the
port imports nothing of the JAX package).  ``get_arch(name)`` loads the ten
arch files on first use."""
from .base import ArchConfig, MambaCfg, MoECfg, RWKVCfg, all_archs, get_arch

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        chameleon_34b,
        deepseek_moe_16b,
        h2o_danube3_4b,
        jamba_1_5_large,
        musicgen_large,
        qwen1_5_4b,
        qwen2_7b,
        qwen2_moe_a2_7b,
        qwen3_14b,
        rwkv6_1b6,
    )
    _LOADED = True


__all__ = ["ArchConfig", "MoECfg", "MambaCfg", "RWKVCfg", "get_arch", "all_archs", "_load_all"]
