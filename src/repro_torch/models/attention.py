"""GQA attention: QKV bias (qwen1.5/qwen2), qk-norm (qwen3), sliding window
(h2o-danube3), RoPE; train/prefill through the flash kernel (or its plain
version) and decode with a KV cache (full, or a ring of ``window`` slots).
The port of ``repro.models.attention``.

KV cache layout: ``k/v: [B, S, Hkv, D]``.  For sliding-window layers the
cache is a ring of ``window`` slots (slot = pos % window).  Decode writes
the new token's K/V into the cache in place (the JAX version rebuilds the
cache through a one-hot blend, which gives the same values) and attends
over every slot with a validity mask, in plain torch as in JAX: the flash
kernel is not used in decode.

Weights keep the JAX layouts: ``wq [d, Hq, D]``, ``wk/wv [d, Hkv, D]``,
``wo [Hq, D, d]``, biases ``[H, D]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import apply_rope, dense, rms_norm, rope_angles, rp_matmul


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S, Hkv, D]
    v: torch.Tensor  # [B, S, Hkv, D]


def attn_init(gen: torch.Generator, cfg: ArchConfig, *, device=None,
              dtype=torch.float32) -> dict:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": dense((d, hq, hd), gen, **kw),
        "wk": dense((d, hkv, hd), gen, **kw),
        "wv": dense((d, hkv, hd), gen, **kw),
        "wo": dense((hq, hd, d), gen, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), **kw)
        p["bk"] = torch.zeros((hkv, hd), **kw)
        p["bv"] = torch.zeros((hkv, hd), **kw)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), **kw)
        p["k_norm"] = torch.ones((hd,), **kw)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk") as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bthk,hkd->btd") as one matmul."""
    h, hd, d = wo.shape
    return rp_matmul(o.reshape(*o.shape[:-2], h * hd), wo.reshape(h * hd, d))


def _project_qkv(p, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    sin, cos = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _causal(p, cfg: ArchConfig, x: torch.Tensor, backend: str):
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True,
                              window=cfg.sliding_window or None,
                              backend=backend)
    return out, k, v


def attn_train(p, cfg: ArchConfig, x: torch.Tensor,
               backend: str = "auto") -> torch.Tensor:
    """Full-sequence causal attention (training / prefill)."""
    out, _, _ = _causal(p, cfg, x, backend)
    return _out(out, p["wo"])


def attn_prefill(p, cfg: ArchConfig, x: torch.Tensor, cache_len: int,
                 backend: str = "auto") -> tuple[torch.Tensor, KVCache]:
    """Prefill: causal attention + a fresh cache of ``cache_len`` slots
    (``min(cache_len, window)`` with a window) holding the last keys and
    values.  Full attention puts them from slot 0; a sliding window puts
    key p in slot ``p % window``, the ring ``attn_decode`` goes on
    writing.  The JAX version puts the window's keys from slot 0 too,
    which is the same ring only when ``T <= window`` or ``T % window ==
    0``: past that its decode evicts the wrong key."""
    B, T, _ = x.shape
    out, k, v = _causal(p, cfg, x, backend)
    cache = make_cache(cfg, B, cache_len, k.dtype, device=x.device)
    take = min(T, cache.k.shape[1])
    src = torch.arange(T - take, T, device=x.device)
    dst = src % cfg.sliding_window if cfg.sliding_window else src - (T - take)
    cache.k[:, dst] = k[:, src]
    cache.v[:, dst] = v[:, src]
    return _out(out, p["wo"]), cache


def attn_decode(p, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                pos: torch.Tensor) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. ``pos``: absolute position of the new token [B].

    Full attention: cache slot ``pos`` is written, attention masked to
    ``<= pos``.  Sliding window: ring of ``window`` slots (slot =
    pos % window), the slots ``<= min(pos, S - 1)`` attended.
    """
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"decode takes one token, got T={T}")
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    S = cache.k.shape[1]
    window = cfg.sliding_window
    slot = (pos % window) if window else pos
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot.long()] = k[:, 0]
    cache.v[rows, slot.long()] = v[:, 0]

    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    qg = q.reshape(B, 1, hkv, hq // hkv, -1)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg, cache.k) / (
        q.shape[-1] ** 0.5)
    last = torch.clamp(pos, max=S - 1) if window else pos
    valid = torch.arange(S, device=x.device)[None, :] <= last[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None, :],
                                float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs, cache.v).reshape(
        B, 1, hq, -1)
    return _out(out, p["wo"]), cache


def make_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
               device=None) -> KVCache:
    slots = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
             else cache_len)
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
