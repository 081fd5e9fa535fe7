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
they divide).  Under the residual row split (``tp.rows``,
``TUNING.residual_spec``) ``x`` is the rank's rows: they are gathered
before the projections (``tp.enter``) and ``wo``'s partial sums are
reduce-scattered to the rank's rows (``tp.leave``), so the cache is
written from every row as without the split.  With the query heads whole
over ``model`` (sequence-parallel attention too) the layer runs whole on
every rank on the gathered rows (``models.model._block_apply``).

Sequence-parallel attention (``TUNING.attn_seq_axis == "model"``, the
``seq_parallel_attn`` preset) takes over when the query heads are whole
over ``model`` (they do not divide it; the dry run resolves the knob so,
per cell, as the reference does): a rank projects q for its slice of the
query rows (``ModelSplit.seq_range``: ceil-sized slices, the last rank
shorter), the keys and values its rows see, attends at ``q_offset`` =
its first row (the flash kernel on the card), runs the whole ``wo`` on
its rows and all-gathers the rows over ``model``, so the residual stream
stays whole on every rank.  The leaves it reads whole and ``x`` enter
through ``tp.copy``.  A contiguous split leaves the causal imbalance:
the last rank sees the most keys.  The reference pins the rows to
``model`` by a sharding constraint; the numbers are the unsharded ones.

``TUNING.cache_seq_shard`` splits a decode cache's slots over ``model``
where the kv heads do not divide it and the slots do (``cache_split``,
``parallel.cache_sharding``'s rule): a rank holds slots ``[r * S / n,
(r + 1) * S / n)`` (a ring's too: key p stays in slot ``p % window``).
Prefill writes the rank's slots; decode writes the new key and value on
the rank that owns slot ``pos``, and each rank attends over its slots
for every q head (gathered over ``model`` when they split): the
softmax's maximum, sum and weighted values are merged across ``model``
(``ModelSplit.max`` and all-reduces, flash-decoding), then ``wo`` runs
as without the split.  Where the batch rows are not split (the dry
run's ``long_500k`` cells, a batch of 1), the reference's rule puts the
slots on ``data`` instead; the port keeps them whole on every rank there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import (
    apply_rope, dense, rms_norm, rope_angles, rp_matmul, split_on,
)
from .tuning import TUNING


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
    rank computes: its share, or all of them when they do not split).
    ``x`` has entered the split (``tp.enter``)."""
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    bk, bv = p.get("bk"), p.get("bv")
    if tp is not None:
        # every rank's products read these whole leaves: their gradients
        # are partial sums
        if tp.dim("wk") is None:
            wk, wv = tp.copy(wk), tp.copy(wv)
            if cfg.qkv_bias:
                bk, bv = tp.copy(bk), tp.copy(bv)
        if cfg.qk_norm:
            q_norm, k_norm = tp.copy(q_norm), tp.copy(k_norm)
    rope = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = _heads(cfg, x, p["wq"], p.get("bq"), q_norm, rope)
    k = _heads(cfg, x, wk, bk, k_norm, rope)
    v = _heads(cfg, x, wv, bv, None, None)
    return q, k, v


def _heads(cfg: ArchConfig, x, w, b, norm, rope) -> torch.Tensor:
    """One projection of ``x`` to heads: the bias (qkv_bias), the norm
    (qk_norm) and RoPE by ``rope`` = ``rope_angles``'s (sin, cos) at the
    rows' positions (None for v)."""
    t = _proj(x, w)
    if cfg.qkv_bias:
        t = t + b
    if cfg.qk_norm and norm is not None:
        t = rms_norm(t, norm, cfg.norm_eps)
    return t if rope is None else apply_rope(t, *rope)


def seq_split(tp):
    """``tp`` when sequence-parallel attention runs: ``TUNING.
    attn_seq_axis`` is "model", ``model`` has more than one rank and
    ``wq``'s heads are whole over it; else None."""
    if tp is None or tp.n == 1 or TUNING.attn_seq_axis != "model" or \
            tp.dim("wq") is not None:
        return None
    return tp


def _seq_causal(p, cfg: ArchConfig, x: torch.Tensor, backend: str, sq,
                all_kv: bool):
    """Causal attention for this rank's slice of the query rows (module
    docstring) -> (out [B, rows, Hq, D], k, v, ``wo`` as the rank reads
    it): k and v of the keys its rows see, or of all ``T`` rows
    (``all_kv``, a prefill's cache)."""
    B, T, _ = x.shape
    lo, hi = sq.seq_range(T)
    W = cfg.sliding_window or None
    k0 = 0 if all_kv or W is None else max(0, lo - W + 1)
    k1 = T if all_kv else hi
    # every rank's rows read x and these whole leaves: partial gradients
    x = sq.copy(x)
    w = {key: sq.copy(t) for key, t in p.items()}
    # the keys' rows [k0, k1) hold the query rows [lo, hi)
    sin, cos = rope_angles(torch.arange(k0, k1, device=x.device).expand(
        B, k1 - k0), cfg.resolved_head_dim, cfg.rope_theta)
    q = _heads(cfg, x[:, lo:hi], w["wq"], w.get("bq"), w.get("q_norm"),
               (sin[:, lo - k0:hi - k0], cos[:, lo - k0:hi - k0]))
    xk = x[:, k0:k1]
    k = _heads(cfg, xk, w["wk"], w.get("bk"), w.get("k_norm"), (sin, cos))
    v = _heads(cfg, xk, w["wv"], w.get("bv"), None, None)
    if hi > lo:
        out = ops.flash_attention(q, k[:, :hi - k0], v[:, :hi - k0],
                                  causal=True, window=W, q_offset=lo - k0,
                                  backend=backend)
    else:  # more ranks than rows
        out = q
    return out, k, v, w["wo"]


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
    if tp is not None:  # every rank's products read x
        x = tp.enter(x)
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
    sq = seq_split(tp)
    if sq is not None:
        out, _, _, wo = _seq_causal(p, cfg, x, backend, sq, all_kv=False)
        return sq.gather_rows(_out(out, wo), x.shape[1])
    tp = split_on(tp, "wq")
    out, _, _ = _causal(p, cfg, x, backend, tp)
    return _out(out, p["wo"], tp)


def cache_split(cfg: ArchConfig, tp, cache_len: int):
    """``tp`` (scoped to the layer's ``attn``) when ``TUNING.
    cache_seq_shard`` splits the layer's KV cache of ``cache_len`` over
    ``model``, by ``parallel.cache_sharding``'s rule: more than one rank,
    the batch rows split (``tp.rows_split``: where they are not, the rule
    puts the slots on ``data`` or keeps them whole), kv heads whole over
    ``model``, the slots a multiple of its size and at least
    ``min(cache_len, 1024) // 2`` (the rule's test for a KV cache); else
    None."""
    if tp is None or tp.n == 1 or not TUNING.cache_seq_shard or \
            not tp.rows_split or tp.dim("wk") is not None:
        return None
    slots = _slots(cfg, cache_len)
    if slots % tp.n or slots < min(cache_len, 1024) // 2:
        return None
    return tp


def _slots(cfg: ArchConfig, cache_len: int) -> int:
    return (min(cache_len, cfg.sliding_window) if cfg.sliding_window
            else cache_len)


def _write_prefill(cfg: ArchConfig, cache: KVCache, k, v, cs,
                   S: int) -> None:
    """The last keys and values of a prefill (``k``/``v``: all its rows)
    into their slots: key p in slot ``p % window`` with a window,
    else from slot 0; with ``cs`` (a split cache) only the rank's slots
    ``[r * S / n, (r + 1) * S / n)`` of the ``S``."""
    dev, T = k.device, k.shape[1]
    take = min(T, S)
    W = cfg.sliding_window
    if cs is None:
        src = torch.arange(T - take, T, device=dev)
        dst = src % W if W else src - (T - take)
        cache.k[:, dst] = k[:, src]
        cache.v[:, dst] = v[:, src]
        return
    # the key each of the rank's slots holds (none past T); by arithmetic,
    # since a mask's shape would be unknown on the dry run's fake tensors
    S_l = cache.k.shape[1]
    d = torch.arange(cs.r * S_l, (cs.r + 1) * S_l, device=dev)
    src = T - take + ((d - (T - take)) % W if W else d)
    held = (src < T)[None, :, None, None]
    src = src.clamp(max=T - 1)
    cache.k.copy_(torch.where(held, k[:, src], 0))
    cache.v.copy_(torch.where(held, v[:, src], 0))


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
    cs = cache_split(cfg, tp, cache_len)
    sq = seq_split(tp)
    if sq is not None:
        out, k, v, wo = _seq_causal(p, cfg, x, backend, sq, all_kv=True)
        y = sq.gather_rows(_out(out, wo), x.shape[1])
    else:
        tp = split_on(tp, "wq")
        out, k, v = _causal(p, cfg, x, backend, tp)
        y = _out(out, p["wo"], tp)
    cache = make_cache(cfg, k.shape[0], cache_len, k.dtype,
                       device=x.device, kv_heads=k.shape[2],
                       parts=1 if cs is None else cs.n)
    _write_prefill(cfg, cache, k, v, cs, _slots(cfg, cache_len))
    return y, cache


def attn_decode(p, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                pos: torch.Tensor, tp=None, cache_len: int = 0
                ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. ``pos``: absolute position of the new token [B].

    Full attention: cache slot ``pos`` is written, attention masked to
    ``<= pos``.  Sliding window: ring of ``window`` slots (slot =
    pos % window), the slots ``<= min(pos, S - 1)`` attended.
    ``cache_len``: the cache's length as made (``cache_split`` decides
    from it whether the cache's slots are split over ``model``).
    """
    if not cache_len and cache_split(cfg, tp, cache.k.shape[1]):
        raise ValueError("a decode under cache_seq_shard needs the cache's "
                         "cache_len")
    cs = cache_split(cfg, tp, cache_len) if cache_len else None
    tp = split_on(tp, "wq")
    if tp is not None:
        x = tp.enter(x)
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"decode takes one token, got T={T}")
    q, k, v = _project_qkv(p, cfg, x, pos[:, None], tp)
    if cs is not None:
        return _decode_split(p, cfg, q, k, v, cache, pos, tp, cs,
                             _slots(cfg, cache_len))
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


def _decode_split(p, cfg: ArchConfig, q, k, v, cache: KVCache,
                  pos: torch.Tensor, tp, cs, S: int
                  ) -> tuple[torch.Tensor, KVCache]:
    """Decode over a cache whose ``S`` slots are split over ``model``
    (``cs``; module docstring): the new key and value on the rank that
    owns slot ``pos``, then the softmax over every rank's slots merged
    by flash-decoding, in f32 as the whole softmax runs; ``tp``: the q
    heads' split, when they split."""
    B = q.shape[0]
    S_l = cache.k.shape[1]
    lo = cs.r * S_l
    window = cfg.sliding_window
    slot = ((pos % window) if window else pos).long() - lo
    mine = (slot >= 0) & (slot < S_l)
    at = slot.clamp(0, S_l - 1)
    rows = torch.arange(B, device=q.device)
    for c, new in ((cache.k, k), (cache.v, v)):
        c[rows, at] = torch.where(mine[:, None, None], new[:, 0],
                                  c[rows, at])
    hq = q.shape[2]
    if tp is not None:  # every q head reads every rank's slots
        q = tp.all_gather(q, 2)
    hkv = cache.k.shape[2]
    qg = q.reshape(B, 1, hkv, q.shape[2] // hkv, -1)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg, cache.k) / (
        q.shape[-1] ** 0.5)
    last = torch.clamp(pos, max=S - 1) if window else pos
    valid = (lo + torch.arange(S_l, device=q.device))[None, :] <= \
        last[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None, :],
                                float("-inf")).float()
    top = cs.max(logits.amax(dim=-1, keepdim=True))  # rank 0 holds slot 0
    e = torch.exp(logits - top)
    probs = (e / cs.all_reduce(e.sum(dim=-1, keepdim=True))).to(q.dtype)
    out = cs.all_reduce(torch.einsum("bhgqs,bshd->bqhgd", probs, cache.v))
    out = out.reshape(B, 1, q.shape[2], -1)
    if tp is not None:
        lo_h = tp.range(hq)[0]
        out = out[:, :, lo_h:lo_h + hq]
    return _out(out, p["wo"], tp), cache


def make_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
               device=None, kv_heads: int | None = None,
               parts: int = 1) -> KVCache:
    """A zero cache of ``kv_heads`` heads (default: all of them); with
    ``parts`` > 1, one rank's ``1 / parts`` of the slots."""
    shape = (batch, _slots(cfg, cache_len) // parts,
             kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
