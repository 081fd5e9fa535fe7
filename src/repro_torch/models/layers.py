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


def split_on(tp, key: str):
    """``tp`` (a ``parallel.tensor_parallel.ModelSplit`` or None) when
    parameter ``key`` of its scope is split over ``model``, else None."""
    return None if tp is None else tp.on(key)


def sub(tp, key: str):
    """``tp`` scoped to module ``key`` (None stays None)."""
    return None if tp is None else tp.sub(key)


def reduce_product(x: torch.Tensor, w: torch.Tensor,
                   reduce) -> torch.Tensor:
    """``x @ w`` whose contraction runs over this rank's part, summed over
    ``model`` by ``reduce`` (a ``ModelSplit``'s ``reduce`` or ``leave``):
    the partial products leave the product in f32 (its accumulator), are
    summed in f32 and rounded once to ``x``'s dtype, so a split product
    rounds as the whole one does.  (The reference's compiled step on the
    host all-reduces in f32 too: XLA promotes a bf16 all-reduce, after
    rounding each partial to bf16.)"""
    return reduce(x.float() @ w.float()).to(x.dtype)


def rp_matmul(x: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """A row-parallel product ``x @ w`` (the JAX ``rp_einsum``): with
    ``TUNING.tp_reduce_dtype`` set, the product is rounded to that dtype
    once, then cast back to ``x``'s (JAX's ``preferred_element_type``
    rounds its f32 accumulation once); a no-op for bf16 inputs.  With
    ``tp`` (a ``ModelSplit``) the contraction runs over this rank's part
    and the partial products are summed over ``model`` (``tp.leave``: an
    all-reduce, or under the residual row split a reduce-scatter to the
    rank's rows): in that dtype when it is set (the wire dtype of JAX's
    psum), else in f32 and rounded once, as ``reduce_product``."""
    reduce_dtype = TUNING.tp_reduce_dtype
    if tp is not None and reduce_dtype is None:
        return reduce_product(x, w, tp.leave)
    out = x @ w
    if reduce_dtype is not None:
        out = out.to(getattr(torch, reduce_dtype))
        if tp is not None:
            out = tp.leave(out)
        out = out.to(x.dtype)
    return out


def whole_rows(tp, fn, x: torch.Tensor) -> tuple:
    """``fn(x, tp)`` -> ``(out, *rest)`` for a module that runs whole on
    every rank, given this rank's rows ``x`` under the residual row split
    (``tp.rows``): the rows gathered, the module run with the split
    without rows, this rank's rows of ``out`` taken.  Without the row
    split, ``fn(x, tp)``."""
    if tp is None or tp.rows is None:
        return fn(x, tp)
    out, *rest = fn(tp.rows_gather(x), tp.whole())
    return (tp.take_rows(out), *rest)


def mlp_apply(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU; with ``tp`` (scoped to this MLP) and ``mlp`` split over
    ``model``, column-parallel ``wi_gate``/``wi_up`` into row-parallel
    ``wo`` (under the residual row split: ``x`` is the rank's rows,
    gathered in, and the output its rows, reduce-scattered out)."""
    sp = split_on(tp, "wo")
    if sp is None and tp is not None and tp.rows is not None:
        return whole_rows(tp, lambda h, t: (mlp_apply(p, h),), x)[0]
    if sp is not None:
        x = sp.enter(x)
    return rp_matmul(F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"]), p["wo"],
                     sp)


# ------------------------------------------------------------- embeddings
def embed_apply(table: torch.Tensor, tokens: torch.Tensor,
                compute_dtype, tp=None) -> torch.Tensor:
    """The lookup; with ``tp`` (the table's vocab split over ``model``)
    a rank looks up the tokens of its vocab range (zeros for the rest)
    and the rows are all-reduced (``tp.leave``: under the residual row
    split, reduce-scattered to the rank's rows): the same values as the
    whole table's lookup."""
    if tp is None:
        return table[tokens.long()].to(compute_dtype)
    V = table.shape[0]
    local = tokens.long() - tp.range(V)[0]
    inside = (local >= 0) & (local < V)
    rows = table[local.clamp(0, V - 1)].to(compute_dtype)
    return tp.leave(rows.masked_fill(~inside[..., None], 0))


def logits_apply(table_or_head: torch.Tensor, x: torch.Tensor,
                 transpose: bool, tp=None) -> torch.Tensor:
    """Final projection; ``transpose=True`` for tied embedding tables.
    With ``tp`` (the vocab split over ``model``): this rank's vocab range
    of the logits."""
    w = cast(table_or_head, x.dtype)
    if tp is not None:
        x = tp.copy(x)
    return x @ (w.t() if transpose else w)
