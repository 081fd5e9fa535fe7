"""Shared LM building blocks on torch tensors (the port of
``repro.models.layers``).

The JAX package wraps each array in ``Param(value, logical_axes)`` for its
sharding rules; here parameters are ``nn.Parameter``s of a
``models.model.ParamTree``, and their logical axes come from
``models.model.logical_axes(cfg)``, keyed by parameter name.  The initialisers draw from an explicit ``torch.Generator``
with the JAX package's distributions: a normal truncated to [-2, 2] times
a scale, ``1/sqrt(fan_in)`` for dense weights with ``fan_in`` the product
of every axis but the last (so ``wq [d, Hq, D]`` has fan-in ``d * Hq``, as
in JAX).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .tuning import TUNING


def normal(shape, gen: torch.Generator, scale: float = 0.02, *,
           device=None, dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2]."""
    t = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


def dense(shape, gen: torch.Generator, *, device=None,
          dtype=torch.float32) -> torch.Tensor:
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    return normal(shape, gen, 1.0 / max(fan_in, 1) ** 0.5, device=device,
                  dtype=dtype)


def cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype`` (no copy when it already is)."""
    return t if t.dtype == dtype else t.to(dtype)


# ---------------------------------------------------------------- RMSNorm
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [*, T] -> (sin, cos) each [*, T, head_dim/2]."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (not interleaved).  x [B, T, H, D]; sin/cos
    [B, T, D/2] (or broadcastable)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------- MLP (SwiGLU)
def mlp_init(gen, d_model: int, d_ff: int, *, device=None,
             dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {
        "wi_gate": dense((d_model, d_ff), gen, **kw),
        "wi_up": dense((d_model, d_ff), gen, **kw),
        "wo": dense((d_ff, d_model), gen, **kw),
    }


def rp_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product ``x @ w`` (the JAX ``rp_einsum``): with
    ``TUNING.tp_reduce_dtype`` set, the product is rounded to that dtype
    once, then cast back to ``x``'s (JAX's ``preferred_element_type``
    rounds its f32 accumulation once); a no-op for bf16 inputs."""
    out = x @ w
    if TUNING.tp_reduce_dtype is not None:
        out = out.to(getattr(torch, TUNING.tp_reduce_dtype)).to(x.dtype)
    return out


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    return rp_matmul(F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"]), p["wo"])


# ------------------------------------------------------------- embeddings
def embed_apply(table: torch.Tensor, tokens: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)


def logits_apply(table_or_head: torch.Tensor, x: torch.Tensor,
                 transpose: bool) -> torch.Tensor:
    """Final projection; ``transpose=True`` for tied embedding tables."""
    w = cast(table_or_head, x.dtype)
    return x @ (w.t() if transpose else w)
