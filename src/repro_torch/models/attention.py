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

With ``tp`` (a ``parallel.tensor_parallel.ModelSplit`` scoped to the
layer's ``attn``) and the query heads split over ``model``, a rank
projects its q heads (column-parallel ``wq``), attends and runs its rows
of ``wo`` (row-parallel, all-reduced).  Its kv heads are its share of
``wk``/``wv`` when they split too, and the heads are then its q heads' kv
heads; when they do not divide ``model`` (``spec_for`` leaves them whole)
a rank computes every kv head and its q heads read the ones that GQA
maps them to.  A cache holds the kv heads the rank computes, as
``parallel.cache_sharding`` lays it out (heads over ``model`` only when
they divide).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import (
    apply_rope, dense, rms_norm, rope_angles, rp_matmul, split_on,
)


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


def _out(o: torch.Tensor, wo: torch.Tensor, tp=None) -> torch.Tensor:
    """einsum("bthk,hkd->btd") as one matmul (row-parallel over this
    rank's heads with ``tp``)."""
    h, hd, d = wo.shape
    return rp_matmul(o.reshape(*o.shape[:-2], h * hd),
                     wo.reshape(h * hd, d), tp)


def _project_qkv(p, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, tp=None):
    """-> q (this rank's heads with ``tp``), k and v (the kv heads the
    rank computes: its share, or all of them when they do not split)."""
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    bk, bv = p.get("bk"), p.get("bv")
    if tp is not None:
        # every rank's products read x and these whole leaves: their
        # gradients are partial sums
        x = tp.copy(x)
        if tp.dim("wk") is None:
            wk, wv = tp.copy(wk), tp.copy(wv)
            if cfg.qkv_bias:
                bk, bv = tp.copy(bk), tp.copy(bv)
        if cfg.qk_norm:
            q_norm, k_norm = tp.copy(q_norm), tp.copy(k_norm)
    q, k, v = _proj(x, p["wq"]), _proj(x, wk), _proj(x, wv)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + bk
        v = v + bv
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    sin, cos = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _kv_of_q(cfg: ArchConfig, tp, hq: int, k: torch.Tensor,
             v: torch.Tensor):
    """The kv heads (dim 2) that this rank's ``hq`` q heads read: all of
    ``k``/``v`` when the kv heads split with the q heads; else the GQA
    heads of its q heads' range, as a slice when they group evenly, or
    one kv head per q head."""
    if tp is None or tp.dim("wk") is not None:
        return k, v
    group = cfg.num_heads // cfg.num_kv_heads
    lo, hi = tp.range(hq)
    first, last = lo // group, (hi - 1) // group + 1
    kv = [(lo + j) // group for j in range(hq)]
    per = hq // (last - first)
    if hq % (last - first) == 0 and kv == [first + j // per
                                           for j in range(hq)]:
        return k[:, :, first:last], v[:, :, first:last]
    idx = torch.tensor(kv, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _causal(p, cfg: ArchConfig, x: torch.Tensor, backend: str, tp=None):
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, cfg, x, positions, tp)
    kq, vq = _kv_of_q(cfg, tp, q.shape[2], k, v)
    out = ops.flash_attention(q, kq, vq, causal=True,
                              window=cfg.sliding_window or None,
                              backend=backend)
    return out, k, v


def attn_train(p, cfg: ArchConfig, x: torch.Tensor,
               backend: str = "auto", tp=None) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill)."""
    tp = split_on(tp, "wq")
    out, _, _ = _causal(p, cfg, x, backend, tp)
    return _out(out, p["wo"], tp)


def attn_prefill(p, cfg: ArchConfig, x: torch.Tensor, cache_len: int,
                 backend: str = "auto", tp=None
                 ) -> tuple[torch.Tensor, KVCache]:
    """Prefill: causal attention + a fresh cache of ``cache_len`` slots
    (``min(cache_len, window)`` with a window) holding the last keys and
    values.  Full attention puts them from slot 0; a sliding window puts
    key p in slot ``p % window``, the ring ``attn_decode`` goes on
    writing.  The JAX version puts the window's keys from slot 0 too,
    which is the same ring only when ``T <= window`` or ``T % window ==
    0``: past that its decode evicts the wrong key."""
    B, T, _ = x.shape
    tp = split_on(tp, "wq")
    out, k, v = _causal(p, cfg, x, backend, tp)
    cache = make_cache(cfg, B, cache_len, k.dtype, device=x.device,
                       kv_heads=k.shape[2])
    take = min(T, cache.k.shape[1])
    src = torch.arange(T - take, T, device=x.device)
    dst = src % cfg.sliding_window if cfg.sliding_window else src - (T - take)
    cache.k[:, dst] = k[:, src]
    cache.v[:, dst] = v[:, src]
    return _out(out, p["wo"], tp), cache


def attn_decode(p, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                pos: torch.Tensor, tp=None) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. ``pos``: absolute position of the new token [B].

    Full attention: cache slot ``pos`` is written, attention masked to
    ``<= pos``.  Sliding window: ring of ``window`` slots (slot =
    pos % window), the slots ``<= min(pos, S - 1)`` attended.
    """
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"decode takes one token, got T={T}")
    tp = split_on(tp, "wq")
    q, k, v = _project_qkv(p, cfg, x, pos[:, None], tp)
    S = cache.k.shape[1]
    window = cfg.sliding_window
    slot = (pos % window) if window else pos
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot.long()] = k[:, 0]
    cache.v[rows, slot.long()] = v[:, 0]

    hq = q.shape[2]
    kc, vc = _kv_of_q(cfg, tp, hq, cache.k, cache.v)
    hkv = kc.shape[2]
    qg = q.reshape(B, 1, hkv, hq // hkv, -1)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg, kc) / (
        q.shape[-1] ** 0.5)
    last = torch.clamp(pos, max=S - 1) if window else pos
    valid = torch.arange(S, device=x.device)[None, :] <= last[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None, :],
                                float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs, vc).reshape(
        B, 1, hq, -1)
    return _out(out, p["wo"], tp), cache


def make_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
               device=None, kv_heads: int | None = None) -> KVCache:
    """A zero cache of ``kv_heads`` heads (default: all of them)."""
    slots = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
             else cache_len)
    shape = (batch, slots, kv_heads or cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
