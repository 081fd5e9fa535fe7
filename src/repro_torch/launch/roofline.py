"""Roofline terms of a step from its operation counts (the port of
``repro.launch.roofline``), on the NVIDIA H100 SXM5 80GB.

The counts come from ``launch.op_cost`` (a dispatch-level walk of the
step, since there is no HLO to read): flops, bytes and the collectives
the step issued.

Wire-byte model (ring algorithms, per card, S = result size, N = group):
  all-gather          S (N-1)/N
  all-reduce          2 S (N-1)/N
  reduce-scatter      S (N-1)          (operand = S*N)
  all-to-all          S (N-1)/N
  collective-permute  S

Terms (seconds; the collective bytes are the per-card wire-byte sum):
  compute    = FLOPs / (cards * PEAK_FLOPS)
  memory     = bytes / (cards * HBM_BW)
  collective = coll_bytes_per_card / link rate, NVLink within a node of 8
               cards, the node's network once a group spans more
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

# NVIDIA H100 SXM5 80GB datasheet, dense, at its 700 W limit
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
NVLINK_BW = 450e9  # NVLink 4: 900 GB/s a card both ways, 450 each way
# a DGX/HGX H100 node: 8 cards on NVLink, one 400 Gb/s NIC a card beyond
NODE_CARDS = 8
NET_BW = 50e9  # 400 Gb/s InfiniBand NDR (ConnectX-7) a card, bytes/s



def wire_bytes(op: str, result_bytes: float, group: int) -> float:
    """Bytes a card puts on the wire for one collective (ring model)."""
    n, s = group, result_bytes
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return s * (n - 1) / n
    if op == "all-reduce":
        return 2 * s * (n - 1) / n
    if op == "reduce-scatter":
        return s * (n - 1)
    if op == "all-to-all":
        return s * (n - 1) / n
    if op == "collective-permute":
        return s
    raise ValueError(f"unknown collective {op!r}")


def link_bw(group: int) -> float:
    """The rate a collective over ``group`` cards runs at per card."""
    return NVLINK_BW if group <= NODE_CARDS else NET_BW


@dataclasses.dataclass
class CollectiveStats:
    """The collectives a step issued: wire bytes per card, by op, their
    count and the largest group (which picks the link rate)."""

    wire_bytes: float = 0.0  # per card
    by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    count: int = 0
    max_group: int = 1

    def add(self, op: str, result_bytes: float, group: int) -> float:
        w = wire_bytes(op, result_bytes, group)
        if w:
            self.wire_bytes += w
            self.by_op[op] += w
            self.count += 1
            self.max_group = max(self.max_group, group)
        return w


def roofline_terms(
    flops: float, bytes_accessed: float, coll_bytes_per_chip: float,
    chips: int, per_device: bool = False, group: int | None = None,
) -> dict:
    """``per_device=True`` when flops/bytes are one card's (the dry run's
    walk of one rank): the sum over cards is per_device * chips, so
    FLOPs/(chips * peak) reduces to per_device_flops/peak.  ``group``:
    the largest collective group (default ``chips``), which picks the
    link rate."""
    div = 1 if per_device else chips
    compute = flops / (div * PEAK_FLOPS)
    memory = bytes_accessed / (div * HBM_BW)
    collective = coll_bytes_per_chip / link_bw(
        chips if group is None else group)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]
    )
    return terms


def model_flops(cfg, tokens: int, mode: str = "train") -> float:
    """MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (inference)."""
    n_active = active_param_count(cfg)
    mult = 6 if mode == "train" else 2
    return mult * n_active * tokens


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    hd = cfg.resolved_head_dim
    total = V * d * (1 if cfg.tie_embeddings else 2)
    for l in range(L):
        kind = cfg.mixer_kind(l)
        if kind == "attn":
            total += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        elif kind == "mamba":
            mc = cfg.mamba
            di = mc.expand * d
            dtr = mc.dt_rank or -(-d // 16)
            total += d * 2 * di + di * (dtr + 2 * mc.d_state) + dtr * di + di * d
        else:  # rwkv
            total += 5 * d * d + d * (cfg.rwkv.mix_lora * 5 + cfg.rwkv.decay_lora) * 2
        if kind == "rwkv":
            total += d * cfg.d_ff * 2 + d * d
        elif cfg.is_moe_layer(l):
            mo = cfg.moe
            dff = mo.d_ff_expert or cfg.d_ff
            total += (mo.top_k + mo.num_shared) * 3 * d * dff + d * mo.num_experts
        else:
            total += 3 * d * cfg.d_ff
    return int(total)
