"""Mixture-of-Experts FFN: shared + routed experts, top-k routing,
capacity-based sort dispatch (the port of ``repro.models.moe``, its
scatter dispatch).

The expanded token->expert assignment is sorted by expert (stable), each
token gets its position within its expert's segment, and tokens beyond
the capacity ``C = max(1, int(Tt*k/E * capacity_factor), min(Tt*k, 32))``
are dropped: they are written to a dump row of the [E*C + 1, d] dispatch
buffer and gather from a zero row.  Expert compute is one batched matrix
product per weight over [E, C, d] (plain products outside any kernel, as
in the JAX package).

Expert counts that do not divide a mesh axis (qwen2-moe's 60) are padded
to ``pad_to`` with dead experts the router never selects (its logits
cover the real experts only).

``lax.top_k`` breaks ties toward the lower index; ``torch.topk`` does not
promise to.  Router probabilities from real inputs do not tie.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import MoECfg
from .layers import dense, mlp_apply, mlp_init, normal


def _experts(shape, gen: torch.Generator, *, device=None,
             dtype=torch.float32) -> torch.Tensor:
    """A dense [E, fan, out] weight (fan-in ``E * fan``, as JAX counts
    it), drawn one expert at a time: ``normal`` draws in f32, so a whole
    [16, 8192, 24576] tensor would need a 12.9 GB temporary."""
    out = torch.empty(shape, device=device, dtype=dtype)
    scale = 1.0 / math.prod(shape[:-1]) ** 0.5
    for e in range(shape[0]):
        out[e] = normal(shape[1:], gen, scale, device=device, dtype=dtype)
    return out


def moe_init(gen: torch.Generator, cfg: MoECfg, d_model: int,
             d_ff_dense: int, *, device=None, dtype=torch.float32) -> dict:
    e = cfg.padded_experts
    dff = cfg.d_ff_expert or d_ff_dense
    kw = dict(device=device, dtype=dtype)
    p = {
        "router": dense((d_model, cfg.num_experts), gen, **kw),
        "wi_gate": _experts((e, d_model, dff), gen, **kw),
        "wi_up": _experts((e, d_model, dff), gen, **kw),
        "wo": _experts((e, dff, d_model), gen, **kw),
    }
    if cfg.num_shared:
        p["shared"] = mlp_init(gen, d_model, cfg.num_shared * dff, **kw)
    return p


def capacity(cfg: MoECfg, tokens: int) -> int:
    """Slots per expert: the capacity-factor bound, floored at
    ``min(tokens * k, 32)`` so a hot expert can take every token of a
    decode step."""
    k, E = cfg.top_k, cfg.num_experts
    return max(1, int((tokens * k / E) * cfg.capacity_factor),
               min(tokens * k, 32))


def moe_apply(p, cfg: MoECfg, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (y [B, T, d], the load-balance aux loss f32)."""
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    Tt = B * T
    E, Ep, k = cfg.num_experts, cfg.padded_experts, cfg.top_k
    C = capacity(cfg, Tt)
    dev = x.device

    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)  # [Tt, E]
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = (topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)).to(x.dtype)

    # ---- position-in-expert via a stable sort ----
    flat_e = topi.reshape(-1)  # [Tt*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(Ep, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))  # no host sync, unlike bincount
    starts = torch.cumsum(counts, 0) - counts  # exclusive
    pos_sorted = torch.arange(Tt * k, device=dev) - starts[sorted_e]
    slot_sorted = torch.where(pos_sorted < C, sorted_e * C + pos_sorted,
                              Ep * C)  # dropped -> the dump row
    disp = x.new_zeros((Ep * C + 1, d))
    disp[slot_sorted] = xf[order // k]
    h = disp[:Ep * C].view(Ep, C, d)
    a = F.silu(torch.bmm(h, p["wi_gate"])) * torch.bmm(h, p["wi_up"])
    ye = torch.bmm(a, p["wo"]).view(Ep * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])  # dropped <- zeros
    slots = torch.empty_like(slot_sorted)
    slots[order] = slot_sorted
    y = (ye[slots].view(Tt, k, d) * topw[..., None]).sum(dim=1)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x).reshape(Tt, d)

    # switch-style load-balance loss
    frac_tokens = counts[:E].float() / max(Tt * k, 1)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y.reshape(B, T, d), aux
