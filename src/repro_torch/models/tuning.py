"""Process-wide knobs of the LM path: the fields of ``repro.models.tuning``
that the serving path reads.

  attn_blocked_min_t   the plain attention evaluates query rows in blocks
                       (``kernels.ref.mha_ref(block_q=...)``) once the
                       query length reaches this, so the [Tq, Tk] score
                       matrix never materialises whole.
  attn_block_q         the query block of that path.
  rwkv_chunk           chunk of ``wkv6_chunked`` (0 = the config's).
  mamba_chunk          selective-scan chunk (0 = the config's), passed to
                       ``ops.mamba_scan`` by the Mamba mixer as the JAX
                       mixer passes it; it only sets the JAX scan's
                       checkpoint boundaries, and neither the kernel nor
                       the plain step scan needs it.

The mesh and sharding knobs of the JAX package (``moe_shard_dispatch``,
``moe_expert_axis`` and the rest) come with ``parallel/``; the MoE layer
runs the scatter dispatch, the JAX default.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Tuning:
    attn_blocked_min_t: int = 8192
    attn_block_q: int = 2048
    rwkv_chunk: int = 0
    mamba_chunk: int = 0


TUNING = Tuning()


def set_tuning(**kw) -> Tuning:
    for k, v in kw.items():
        if not hasattr(TUNING, k):
            raise AttributeError(f"unknown tuning knob {k!r}")
        setattr(TUNING, k, v)
    return TUNING
