"""Batched WoW search on a torch device — the serving path.

Executes Algorithm 2+3 for B queries in a hop loop over device tensors.
Per hop, every active query:

  1. selects its nearest unexpanded candidate (the paper's min-heap pop),
  2. gathers that vertex's neighbor block across all layers [0, l_d],
  3. applies the early-stop layer mask — a layer below ``l`` contributes only
     if every layer above it (up to ``l_d``) had an unvisited out-of-range
     neighbor (Alg. 2's ``next`` flag, evaluated vectorially),
  4. selects at most ``m+1`` eligible (valid, unvisited, in-range) neighbors
     by layer-priority rank (the ``c_n`` cap with high-layer priority),
     deduplicated across layers,
  5. evaluates their distances with the fused gather+distance CUDA kernel
     (``repro_torch.kernels.ops.gather_norm_dot``: the factorised
     ``|v|^2 - 2 v.q + |q|^2`` with int8/bf16 dequant in registers),
  6. merges them into its sorted fixed-width result array (heap semantics:
     the width-W sorted array is exactly the paper's U).

This is the port of ``repro.core.device_search`` (fused pipeline, serving
half).  Every stage computes the same integers as the JAX version; where
JAX leans on uint32 arithmetic or ops torch lacks, the port says how it
gets the same bits:

  * **Hashing** (``_hash_probe``) — murmur3-fmix32 in int64, reduced mod
    2^32 after every step; the 32x32-bit multiply is split into 16-bit
    halves so no int64 product overflows.
  * **Visited words** — int64 tensors holding the uint32 word values, so
    shifts and masks never meet a sign bit.  The bitmap marks with a
    ``scatter_add_`` (a selected id's bit is unset, so add == OR); the blocked-Bloom filter OR-combines the masks of lanes sharing a
    word through 32 bit planes (torch has no bitwise-or reduction) and
    writes with a ``scatter_`` (lanes sharing a word write identical
    values).
  * **Packed sort keys** — dedupe ``id*(F+1)+rank`` and admission
    ``rank*(F+1)+pos`` keys are int64, so one stable ``torch.sort`` path
    covers every table size (JAX needs a two-key lexsort once n*(F+1)
    reaches 2^32; both give this order).
  * **Hop loop** — a Python loop that reads ``active.any()`` once per hop
    (one host sync per hop); the hop count, the iteration counter ``t``
    (a host int here) and the ``max_hops + 1`` cap match JAX exactly.  The
    seed iteration (t = 0) injects the entry vertex and skips the neighbor
    pipeline, whose results it would discard.
  * **Ties** — ``torch.argmin``/``argmax`` return the first extremal index,
    as ``jnp`` does; ``searchsorted`` sides map to ``right=False/True``.

Visited-set state (``visited=``): ``"bitmap"`` — an exact [B, n/32 + 1]
packed bitmap (the +1 is a trash word for invalid lanes); ``"hash"`` — a
constant-size blocked Bloom filter sized from the search budget
(``visited_filter_bits``), one word per id with ``v_hashes`` bits inside
it.  A false positive only skips a candidate, so no out-of-range vertex is
ever evaluated.

Scheduling (``compact=``): ``None`` runs one lock-step loop over the whole
batch; ``(h0, h)`` runs resumable chunks of ``h0`` then ``h`` hops and
compacts the still-active queries into the next bucket between chunks
(``_drive_chunked``).  Per-query trajectories are iteration-indexed and
independent, so both give the same results.

Termination per query: no unexpanded candidates, or the nearest unexpanded
is farther than the current worst of a full result set (Alg. 2 line 6).
Out-of-range vertices are never distance-evaluated; per-query DC and hop
counters are returned for parity tests.

Pipelines (``pipeline=``): ``"fused"`` (the default) runs the stages
above; ``"reference"`` runs the pre-refactor hop of
``core.hop_reference`` — all-pairs dedupe + ``torch.topk`` admission, the
rehash mark of the selected ids, a materialized [B, K, d] gather through
the ``batched_dot`` CUDA kernel with cached norms, and a stable full-width
sort merge.  Both give the same ids, DC and hops (the parity oracle); the
reference pipeline takes f32 slabs only.

Build half (``build_search``): one micro-batch's per-layer construction
search of ``WoWIndex.insert_batch(backend="device")`` over the
``DeviceBuildArena`` — the same hop body, seeded with the host-sampled
window entries and the Thm-3.1 carry (``_init_build_state``), run through
the chunked compaction driver, read back once per (micro-batch, layer).
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels.ops import BACKENDS, gather_norm_dot, merge_src_indices
from ..monitoring import record_event
from .hop_reference import dedupe_pairwise, eval_materialized, merge_full_sort
from .snapshot import Snapshot, writable
from .store import VEC_DTYPES, quantize_rows

_INF = float("inf")
_BIG = 2**30
_MASK32 = 0xFFFFFFFF
_MIN_BUCKET = 8  # smallest compaction bucket
MERGE_METHODS = ("auto", "sort", "scatter", "onehot")
PIPELINES = ("fused", "reference")


class DeviceIndex(NamedTuple):
    """Snapshot tensors on one device (static config passed separately)."""

    vectors: torch.Tensor  # {f32|bf16|int8}[n, d] (storage mode = vec_dtype)
    sq_norms: torch.Tensor  # f32[n]
    attrs: torch.Tensor  # f32[n]
    neighbors: torch.Tensor  # i32[L, n, m]
    uvals: torch.Tensor  # f32[u]
    uval_rep: torch.Tensor  # i32[u]
    scales: torch.Tensor  # f32[n] per-row int8 dequant scales (f32[1]
    #   dummy for f32/bf16 slabs)


def _gather_scales(di: DeviceIndex):
    """Per-row dequant scales iff the slab is int8."""
    return di.scales if di.vectors.dtype == torch.int8 else None


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a contiguous writable copy of ``a`` where needed.
    A checkpoint cold start hands read-only memory-mapped slabs here
    (``load_serving_snapshot``): ``torch.from_numpy`` on one would alias
    the mapping (``.to("cpu")`` is a no-op), so such an array is copied
    once on the host (``writable``) before it becomes a tensor."""
    return torch.from_numpy(writable(np.ascontiguousarray(a)))


def _slab_tensor(vectors: np.ndarray, device) -> torch.Tensor:
    """numpy slab -> device tensor; a bf16 slab arrives as uint16 bits."""
    if vectors.dtype == np.uint16:
        t = _host_tensor(vectors.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return _host_tensor(vectors).to(device)


def to_device_index(snap: Snapshot, vec_dtype: str | None = None,
                    device=None) -> DeviceIndex:
    """Device-resident snapshot with **pow2-padded row capacity**.

    The padding is unreachable, so results are those of the unpadded index
    for finite filter ranges: pad neighbor rows are ``-1`` (never
    gathered), pad attrs are ``+inf`` (outside any finite range), and pad
    uvals are ``+inf`` with representative 0 — ``searchsorted`` positions
    for finite query bounds are unchanged by an all-``+inf`` tail.  The
    padding keeps shapes stable across ingest: in JAX the compiled ones,
    here the serve engine's buffers and the CUDA graphs captured on them
    (``serve.lifecycle``), and it keeps the two packages' tensors equal.

    ``vec_dtype`` selects the device slab storage mode ("f32"/"int8"/
    "bf16"; default: the snapshot's own ``vec_dtype``).  Quantized slabs
    already carried by the snapshot are reused as-is; otherwise the f32
    slab is quantized here, per row.  Pad rows get scale 1.0.
    """
    dev = resolve_device(device)
    if vec_dtype is None:
        vec_dtype = getattr(snap, "vec_dtype", "f32")
    if vec_dtype not in VEC_DTYPES:
        raise ValueError(f"vec_dtype must be one of {VEC_DTYPES}")
    n = int(snap.vectors.shape[0])
    u = int(snap.uvals.shape[0])
    pad_n = _pow2ceil(max(n, 1)) - n
    pad_u = _pow2ceil(max(u, 1)) - u

    def _pad(arr, pad, value):
        width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, width, constant_values=value)

    scales = None
    if (
        getattr(snap, "q_vectors", None) is not None
        and getattr(snap, "vec_dtype", "f32") == vec_dtype
        and vec_dtype != "f32"
    ):
        vectors = np.asarray(snap.q_vectors)
        scales = (None if snap.q_scales is None
                  else np.asarray(snap.q_scales, np.float32))
    else:
        vectors, scales = quantize_rows(np.asarray(snap.vectors, np.float32),
                                        vec_dtype)
    sq_norms = np.asarray(snap.sq_norms, np.float32)
    attrs = np.asarray(snap.attrs, np.float32)
    neighbors = np.asarray(snap.neighbors, np.int32)
    uvals = np.asarray(snap.uvals, np.float32)
    uval_rep = np.asarray(snap.uval_rep, np.int32)
    if pad_n:
        vectors = _pad(vectors, pad_n, 0)
        sq_norms = _pad(sq_norms, pad_n, 0.0)
        attrs = _pad(attrs, pad_n, np.inf)
        neighbors = np.pad(neighbors, ((0, 0), (0, pad_n), (0, 0)),
                           constant_values=-1)
        if scales is not None:
            scales = _pad(scales, pad_n, 1.0)
    if pad_u:
        uvals = _pad(uvals, pad_u, np.inf)
        uval_rep = _pad(uval_rep, pad_u, 0)
    if scales is None:
        scales = np.ones(1, np.float32)  # dummy (f32/bf16 slab)

    def _t(a):
        return _host_tensor(a).to(dev)

    return DeviceIndex(
        vectors=_slab_tensor(vectors, dev),
        sq_norms=_t(sq_norms),
        attrs=_t(attrs),
        neighbors=_t(neighbors),
        uvals=_t(uvals),
        uval_rep=_t(uval_rep),
        scales=_t(scales),
    )


def from_reference(snap_like, vec_dtype: str | None = None) -> Snapshot:
    """The port's ``Snapshot`` from any object carrying the JAX package's
    ``Snapshot`` fields as numpy arrays (vectors, sq_norms, attrs,
    neighbors, uvals, uval_rep, ids_map, m, o, metric, q_vectors, q_scales,
    vec_dtype) — how a reference-built index is served from this package.
    Duck-typed: nothing of ``repro`` is imported.  A bf16 ``q_vectors``
    slab (``ml_dtypes.bfloat16`` there) is carried as its uint16 bits.
    ``vec_dtype`` overrides the storage mode; a mode other than the
    source's drops its pre-quantized slabs (re-quantized at upload)."""
    src_mode = getattr(snap_like, "vec_dtype", "f32")
    mode = src_mode if vec_dtype is None else vec_dtype
    q_vectors = getattr(snap_like, "q_vectors", None)
    q_scales = getattr(snap_like, "q_scales", None)
    if mode != src_mode or q_vectors is None:
        q_vectors = q_scales = None
    else:
        q_vectors = np.asarray(q_vectors)
        if mode == "bf16":
            q_vectors = q_vectors.view(np.uint16)
        if q_scales is not None:
            q_scales = np.asarray(q_scales, np.float32)
    return Snapshot(
        vectors=np.asarray(snap_like.vectors, np.float32),
        sq_norms=np.asarray(snap_like.sq_norms, np.float32),
        attrs=np.asarray(snap_like.attrs, np.float32),
        neighbors=np.asarray(snap_like.neighbors, np.int32),
        uvals=np.asarray(snap_like.uvals, np.float32),
        uval_rep=np.asarray(snap_like.uval_rep, np.int32),
        ids_map=np.asarray(snap_like.ids_map, np.int64),
        m=int(snap_like.m),
        o=int(snap_like.o),
        metric=str(snap_like.metric),
        stamp=int(getattr(snap_like, "stamp", -1)),
        q_vectors=q_vectors,
        q_scales=q_scales,
        vec_dtype=mode,
    )


class SearchResult(NamedTuple):
    ids: np.ndarray  # i32[B, k] snapshot ids, -1 padded
    dists: np.ndarray  # f32[B, k], +inf padded
    dc: np.ndarray  # i32[B] distance computations
    hops: np.ndarray  # i32[B]


class HopCfg(NamedTuple):
    """Static hop-loop configuration."""

    k: int
    width: int
    m: int
    o: int
    metric: str
    max_hops: int
    backend: str
    pipeline: str  # "fused" | "reference"
    visited: str  # "bitmap" | "hash"
    v_words: int  # hash-filter words per query (0 for bitmap)
    v_hashes: int
    merge: str  # counting-merge writeback: "auto" | "sort" | ...


class HopState(NamedTuple):
    """Resumable per-query hop state — every tensor is leading-dim B, so
    chunk-boundary compaction is one row gather.  Integer tensors are
    int64 (torch's index type); ``vstate`` holds uint32 word values."""

    queries: torch.Tensor  # f32[B, d] (normalised for cosine)
    q2: torch.Tensor  # f32[B]
    x: torch.Tensor  # f32[B] range lo
    y: torch.Tensor  # f32[B] range hi
    l_d: torch.Tensor  # [B] landing layer
    l_min: torch.Tensor  # [B] lowest layer swept (0 when serving)
    ep: torch.Tensor  # [B] entry vertex (consumed by the seed hop)
    res_d: torch.Tensor  # f32[B, W] sorted result distances
    res_i: torch.Tensor  # [B, W]
    res_e: torch.Tensor  # bool[B, W] expanded
    vstate: torch.Tensor  # [B, Vw+1] visited filter (+1 trash word)
    active: torch.Tensor  # bool[B]
    dc: torch.Tensor  # [B]
    hops: torch.Tensor  # [B]
    t: int  # global iteration counter (0 = seed), kept on the host


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def _default_max_hops(width: int) -> int:
    """Global iteration cap from the beam width (the sorted beam drains
    after O(width) expansions; the 8x + 64 slack covers pathological
    workloads without unbounding the loop)."""
    return 8 * int(width) + 64


def _bucket_ceil(x: int) -> int:
    """Compaction bucket size: smallest of {pow2, 1.5*pow2} >= x (8, 12,
    16, 24, 32, 48, ...): a 128-batch with 68 survivors shrinks to 96."""
    x = max(int(x), _MIN_BUCKET)
    p = 1 << (x - 1).bit_length()
    return p * 3 // 4 if p * 3 // 4 >= x else p


def _bloom_bits(budget: int, fp: float, hashes: int) -> int:
    """Blocked-Bloom size (bits, power of two) for ``budget`` insertions at
    the ``fp`` false-positive target: ``fp = (1 - exp(-nh*I/bits))^nh``
    solved for ``bits``, padded 1.5x for the 32-bit blocked layout, and
    rounded up to a power of two."""
    p1 = fp ** (1.0 / hashes)
    need = 1.5 * hashes * max(int(budget), 1) / -math.log1p(-p1)
    return 1 << max(10, math.ceil(math.log2(need)))


def visited_filter_bits(
    width: int,
    m: int,
    max_hops: int,
    fp: float = 0.02,
    hashes: int = 2,
) -> int:
    """Worst-case hash-filter sizing from the search budget: at most
    ``m+1`` ids are inserted per hop over ``min(max_hops, 2*width + 64)``
    hops (a runaway query past the budget degrades to extra skipping, not
    to O(n) state)."""
    budget = (min(max_hops, 2 * width + 64) + 1) * (m + 1)
    return _bloom_bits(budget, fp, hashes)


def _measured_bits_from_p99(
    p99: float, m: int, fp: float, hashes: int, slack: float,
    floor_hops: int,
) -> int:
    budget = (max(floor_hops, int(math.ceil(slack * p99))) + 1) * (m + 1)
    return _bloom_bits(budget, fp, hashes)


def visited_filter_bits_measured(
    hops,
    m: int,
    fp: float = 0.02,
    hashes: int = 2,
    slack: float = 1.5,
    floor_hops: int = 16,
) -> int:
    """Adaptive hash-filter sizing from *measured* per-query hop counts:
    ``slack * p99(hops)`` hops (never below ``floor_hops``) instead of the
    worst-case ``2*width + 64``.  An under-estimate only costs extra
    skipping on outlier queries; pow2 rounding makes repeated re-estimates
    land on the same size (and the same captured graphs)."""
    hops = np.asarray(hops)
    p99 = float(np.percentile(hops, 99)) if hops.size else 0.0
    return _measured_bits_from_p99(p99, m, fp, hashes, slack, floor_hops)


def hist_percentile(hist, q: float) -> float:
    """Percentile of a hop histogram (bin i = searches that took i hops),
    ``np.percentile``'s linear interpolation from the cumulative counts;
    0.0 for an empty histogram."""
    hist = np.asarray(hist, np.int64)
    total = int(hist.sum())
    if total == 0:
        return 0.0
    rank = (total - 1) * (q / 100.0)
    lo_k = int(math.floor(rank))
    hi_k = int(math.ceil(rank))
    cum = np.cumsum(hist)
    v_lo = int(np.searchsorted(cum, lo_k + 1))  # 0-indexed order stats
    v_hi = int(np.searchsorted(cum, hi_k + 1))
    return v_lo + (rank - lo_k) * (v_hi - v_lo)


def visited_filter_bits_from_hist(
    hist,
    m: int,
    fp: float = 0.02,
    hashes: int = 2,
    slack: float = 1.5,
    floor_hops: int = 16,
) -> int:
    """``visited_filter_bits_measured`` from a hop histogram (the serve
    engine's rolling per-wave histogram); both size alike for the same
    data."""
    p99 = hist_percentile(hist, 99.0)
    return _measured_bits_from_p99(p99, m, fp, hashes, slack, floor_hops)


def chunk_schedule_from_hist(
    hist, lo: int = 4, hi: int = 64
) -> tuple[int, int]:
    """Compaction schedule ``(h0, h)`` from a live hop histogram: ``h0``
    just past p50 retires the fast half of a wave at the first boundary,
    ``h`` a quarter of the p50..p99 spread re-buckets the stragglers a few
    times; both pow2 in ``[lo, hi]`` so re-estimates reuse a handful of
    captured chunk shapes."""
    p50 = hist_percentile(hist, 50.0)
    p99 = hist_percentile(hist, 99.0)
    h0 = _pow2ceil(max(int(math.ceil(p50)) + 1, 1))
    h1 = _pow2ceil(max(int(math.ceil((p99 - p50) / 4.0)), 1))
    clamp = lambda x: max(lo, min(hi, x))  # noqa: E731
    return clamp(h0), clamp(h1)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` < 2^32 and a constant ``c`` <
    2^32, in 16-bit halves so no int64 product overflows."""
    lo = h * (c & 0xFFFF)  # < 2^48
    hi = (h * (c >> 16)) & 0xFFFF  # only its low 16 bits survive the shift
    return (lo + (hi << 16)) & _MASK32


def _hash_probe(ids: torch.Tensor):
    """One murmur3-fmix32 hash per id -> (block hash, first bit offset b0,
    odd offset stride), all int64 holding uint32 values.  Bit-identical to
    ``repro.core.device_search._hash_probe`` and to the numpy
    ``hash_positions_np`` (an id is read as its uint32 bit pattern)."""
    h = ids.long() & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    b0 = (h >> 16) & 31
    step = ((h >> 21) & 31) | 1
    return h, b0, step


def _hash_wordmask(ids: torch.Tensor, v_words: int, nh: int):
    """Blocked-Bloom probe of each id -> (block word index, nh-bit in-word
    mask): the hash's low bits pick the block, the in-word bit offsets are
    ``(b0 + i*step) & 31``."""
    h, b0, step = _hash_probe(ids)
    word = h & (v_words - 1)
    one = torch.ones_like(h)
    mask = torch.zeros_like(h)
    for i in range(nh):
        mask = mask | (one << ((b0 + i * step) & 31))
    return word, mask


def _hash_positions(ids: torch.Tensor, v_bits: int, nh: int) -> torch.Tensor:
    """Flat probe bit positions of ids [...] -> int64 [..., nh] in
    [0, v_bits): the blocked layout as positions (every probe of an id
    lies in one 32-bit block), as the dense oracle and host twin read it."""
    h, b0, step = _hash_probe(ids)
    word = h & (v_bits // 32 - 1)
    i = torch.arange(nh, dtype=torch.int64, device=ids.device)
    bits = (b0[..., None] + i * step[..., None]) & 31
    return word[..., None] * 32 + bits


def _visited_test(vstate: torch.Tensor, ids: torch.Tensor,
                  valid: torch.Tensor, cfg: HopCfg) -> torch.Tensor:
    """Membership of clipped ids [B, ...] in the visited filter -> bool
    (invalid lanes arbitrary); one word gather per candidate."""
    return _visited_test_cached(vstate, ids, valid, cfg)[0]


def _visited_test_cached(vstate: torch.Tensor, ids: torch.Tensor,
                         valid: torch.Tensor, cfg: HopCfg):
    """Membership of clipped ids [B, ...] in the visited filter -> (bool,
    probe cache).  Invalid lanes return arbitrary values (callers mask with
    ``valid``).  The cache is the hash mode's ``(word, mask)`` (None for the
    bitmap) so the mark of the selected subset can gather, not rehash."""
    B = vstate.shape[0]
    trash = vstate.shape[1] - 1
    if cfg.visited == "bitmap":
        word = (ids >> 5).masked_fill(~valid, trash)
        got = torch.gather(vstate, 1, word.reshape(B, -1)).reshape(ids.shape)
        return ((got >> (ids & 31)) & 1) > 0, None
    word, mask = _hash_wordmask(ids, trash, cfg.v_hashes)
    got = torch.gather(vstate, 1, word.reshape(B, -1)).reshape(ids.shape)
    return (got & mask) == mask, (word, mask)


def _visited_mark(vstate: torch.Tensor, sel_ids: torch.Tensor,
                  sel_valid: torch.Tensor, cfg: HopCfg) -> torch.Tensor:
    """Insert the selected ids [B, K] into the filter, in place; returns
    ``vstate``."""
    trash = vstate.shape[1] - 1
    sel_ids = sel_ids.long()
    if cfg.visited == "bitmap":
        # a selected id is unvisited by construction, so its bit is unset
        # and ``add`` == OR; post-dedupe ids are distinct within a row
        w = (sel_ids >> 5).masked_fill(~sel_valid, trash)
        b = (torch.ones_like(sel_ids) << (sel_ids & 31)).masked_fill(
            ~sel_valid, 0)
        vstate.scatter_add_(1, w, b)
        return vstate
    word, mask = _hash_wordmask(sel_ids, trash, cfg.v_hashes)
    return _visited_mark_hash(vstate, word, mask, sel_valid)


def _visited_mark_hash(vstate: torch.Tensor, word: torch.Tensor,
                       mask: torch.Tensor,
                       sel_valid: torch.Tensor) -> torch.Tensor:
    """Hash-mode insert from precomputed probe (word, mask) pairs [B, K],
    in place.  Marking must be an OR (probe bits of an unvisited id may
    already be set): OR-combine the masks of lanes sharing a word, merge
    with the current words, write back with a ``scatter_`` — lanes sharing
    a word write identical values.  torch has no bitwise-or reduction, so
    the masks are split into 32 bit planes, OR-ed with ``any`` over the
    lanes sharing a word, and packed back (distinct bits: the sum is the
    OR)."""
    trash = vstate.shape[1] - 1
    w = word.masked_fill(~sel_valid, trash)
    mask = mask.masked_fill(~sel_valid, 0)
    eqw = w[:, :, None] == w[:, None, :]  # [B, K, K] (tiny)
    bit = torch.arange(32, device=mask.device)
    planes = ((mask[:, :, None] >> bit) & 1) > 0  # [B, K, 32]
    hit = (eqw[:, :, :, None] & planes[:, None, :, :]).any(dim=2)
    comb = (hit.long() << bit).sum(dim=2)  # [B, K]
    cur = torch.gather(vstate, 1, w)
    vstate.scatter_(1, w, cur | comb)
    return vstate


def _dedupe_sorted(ids_f: torch.Tensor, rank_f: torch.Tensor, F: int):
    """Sort-based cross-layer dedupe: pack ``id*(F+1) + rank`` (ineligible
    ranks pack as F) into one int64 key, sort, unpack, and drop an entry
    whose sorted predecessor carries the same id.  Returns the (id-sorted
    ids, masked ranks) pair — the order differs from the input, which is
    fine for the rank top-k that follows."""
    rix = rank_f.masked_fill(rank_f >= _BIG, F)
    skey = torch.sort(ids_f * (F + 1) + rix, dim=1, stable=True).values
    sid = skey // (F + 1)
    srank = skey % (F + 1)
    srank = srank.masked_fill(srank >= F, _BIG)
    dup = sid[:, 1:] == sid[:, :-1]
    srank = torch.cat([srank[:, :1], srank[:, 1:].masked_fill(dup, _BIG)],
                      dim=1)
    return sid, srank


def _admit(ids_f: torch.Tensor, rank_f: torch.Tensor, F: int, K: int):
    """Admission = the K best-ranked survivors: one packed single-key sort
    of ``rank*(F+1) + position`` (ranks are injective over slots, so the
    keys are distinct).  -> (sel_ids, sel_rank, sel_valid), each [B, K]."""
    posF = torch.arange(F, device=ids_f.device)[None, :]
    key2 = rank_f.clamp(max=F) * (F + 1) + posF
    key2 = torch.sort(key2, dim=1, stable=True).values[:, :K]
    sel_rank = key2 // (F + 1)
    sel_pos = key2 % (F + 1)
    sel_valid = sel_rank < F
    sel_ids = torch.gather(ids_f, 1, sel_pos).masked_fill(~sel_valid, 0)
    return sel_ids, sel_rank, sel_valid


def _merge_sorted(res_d, res_i, res_e, dd, new_i, new_e, W: int,
                  method: str = "auto"):
    """Stable sort-free two-way merge of the sorted width-W result arrays
    with K (unsorted) new entries; keeps the W nearest.  Reproduces the
    stable full-width sort of [res | new] (result entries before new
    entries on ties, new entries in slot order) without sorting [B, W+K]:
    a [B, K, K] comparison gives each new entry its stable rank among the
    new ones, a [B, W, K] ``<=`` matrix counts cross positions, and
    ``merge_src_indices`` inverts the position bijection."""
    B, K = dd.shape
    kio = torch.arange(K, device=dd.device)
    lt = dd[:, :, None] > dd[:, None, :]
    eq_earlier = (dd[:, :, None] == dd[:, None, :]) & (
        kio[None, :, None] > kio[None, None, :]
    )
    rank_new = (lt | eq_earlier).sum(dim=2)  # [B, K]
    cmp = (res_d[:, :, None] <= dd[:, None, :]).long()  # [B, W, K]
    pos_a = torch.arange(W, device=dd.device)[None, :] + (K - cmp.sum(dim=2))
    pos_b = rank_new + cmp.sum(dim=1)
    src = merge_src_indices(pos_a, pos_b, W, K, method=method)
    out_d = torch.gather(torch.cat([res_d, dd], dim=1), 1, src)
    out_i = torch.gather(torch.cat([res_i, new_i], dim=1), 1, src)
    out_e = torch.gather(torch.cat([res_e, new_e], dim=1), 1, src)
    return out_d, out_i, out_e


def _landing_and_entry(di: DeviceIndex, ranges: torch.Tensor, o: int,
                       num_layers: int):
    """Alg. 3 step 1: selectivity (via unique values), landing layer,
    entry vertex.  -> (l_d, ep, has), with l_d and ep int64."""
    x = ranges[:, 0].contiguous()
    y = ranges[:, 1].contiguous()
    uvals = di.uvals
    u_last = uvals.shape[0] - 1
    lo = torch.searchsorted(uvals, x, right=False)
    hi = torch.searchsorted(uvals, y, right=True) - 1
    has = hi >= lo
    n_prime = (hi - lo + 1).clamp(min=1)
    # argmax over layers of min(2 o^l, n')/max(2 o^l, n') — unimodal in l
    # with its peak at l_h or l_h+1 (Alg. 3 lines 2-3)
    w_l = torch.as_tensor(2 * (float(o) ** np.arange(num_layers)),
                          dtype=torch.float32, device=x.device)[None, :]
    npf = n_prime.float()[:, None]
    ratio = torch.minimum(w_l, npf) / torch.maximum(w_l, npf)
    l_d = torch.argmax(ratio, dim=1)
    # entry: representative vertex of the in-range value closest to the
    # filter median (Alg. 3 line 4); clip(x, lo, hi) = min(max(x, lo), hi)
    med = (x + y) * 0.5
    pos = torch.searchsorted(uvals, med, right=False)
    cand_hi = torch.minimum(torch.maximum(pos, lo), hi)
    cand_lo = torch.minimum(torch.maximum(pos - 1, lo), hi)
    v_hi = uvals[cand_hi.clamp(0, u_last)]
    v_lo = uvals[cand_lo.clamp(0, u_last)]
    pick_lo = (v_lo - med).abs() <= (v_hi - med).abs()
    ep_uidx = torch.where(pick_lo, cand_lo, cand_hi)
    ep = di.uval_rep[ep_uidx.clamp(0, u_last)].long()
    return l_d, ep, has


def _row_sq(x: torch.Tensor) -> torch.Tensor:
    """``|x_b|^2`` per row, with the same bits at every batch size.  On the
    card torch's row reduction gives a short row to more threads when the
    batch has fewer than 16 rows, which changes its summation order, so
    the reduction always runs over at least 16 rows (zero rows appended);
    a member's norm is then the same in a slice of the batch (the sharded
    build, mesh serving) as in the whole."""
    B = x.shape[0]
    sq = x * x
    if B < 16:
        sq = torch.cat([sq, sq.new_zeros((16 - B, x.shape[1]))])
    return sq.sum(dim=1)[:B]


def _init_state(di: DeviceIndex, queries: torch.Tensor, ranges: torch.Tensor,
                cfg: HopCfg) -> HopState:
    """Empty result set, empty visited filter, entry point staged for the
    seed iteration (hop 0 performs the entry evaluation in-loop)."""
    B, _ = queries.shape
    L, n, _ = di.neighbors.shape
    dev = queries.device
    W = max(cfg.width, cfg.k)
    queries = queries.float()
    if cfg.metric != "l2":
        # cosine: match the host path, which normalises the query at search
        # time (stored vectors are pre-normalised at insert)
        qn = torch.sqrt(_row_sq(queries))[:, None]
        queries = queries / torch.where(qn > 0, qn, torch.ones_like(qn))
    ranges = ranges.float()
    l_d, ep, has = _landing_and_entry(di, ranges, cfg.o, L)
    v_words = ((n + 31) // 32) if cfg.visited == "bitmap" else cfg.v_words
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    return HopState(
        queries=queries,
        q2=_row_sq(queries),
        x=ranges[:, 0],
        y=ranges[:, 1],
        l_d=l_d,
        l_min=zeros,
        ep=ep.masked_fill(~has, 0),
        res_d=torch.full((B, W), _INF, device=dev),
        res_i=torch.full((B, W), -1, dtype=torch.int64, device=dev),
        # pad entries count as expanded, so they are never popped
        res_e=torch.ones((B, W), dtype=torch.bool, device=dev),
        vstate=torch.zeros((B, v_words + 1), dtype=torch.int64, device=dev),
        active=has,
        dc=zeros,
        hops=zeros,
        t=0,
    )


def _select_candidates(di: DeviceIndex, cfg: HopCfg, st: HopState,
                       act: torch.Tensor, s: torch.Tensor):
    """Steps 2-4 of a hop for expanded vertices ``s`` [B]: gather the
    multi-layer neighbor block, test the visited filter, apply the range
    filter and the early-stop layer mask, dedupe across layers and admit
    the K best-ranked.  Marks the admitted ids visited.  -> (sel_ids,
    sel_valid), [B, K]."""
    B = s.shape[0]
    L, n, m = di.neighbors.shape
    F = L * m
    K = min(m + 1, F)
    dev = s.device
    lev = torch.arange(L, device=dev)[None, :, None]  # [1, L, 1]
    col = torch.arange(m, device=dev)[None, None, :]  # [1, 1, m]

    nb = di.neighbors[:, s, :].permute(1, 0, 2).long()  # [B, L, m]
    valid = nb >= 0
    nbc = nb.clamp(0, n - 1)
    a_nb = di.attrs[nbc]  # [B, L, m]
    vis, probe_cache = _visited_test_cached(st.vstate, nbc, valid, cfg)
    unvis = valid & ~vis
    inr = (a_nb >= st.x[:, None, None]) & (a_nb <= st.y[:, None, None])

    # ---- early-stop layer inclusion mask (Alg. 2 lines 7-17) ----
    below_ld = lev <= st.l_d[:, None, None]  # [B, L, 1]
    oor_unvis = (unvis & ~inr & below_ld).any(dim=2)  # [B, L]
    neutral = oor_unvis | ~below_ld[:, :, 0]
    shifted = torch.cat(
        [neutral[:, 1:], torch.ones((B, 1), dtype=torch.bool, device=dev)],
        dim=1,
    )
    # a layer is included iff every layer above it had the flag set: a
    # reversed cumulative product (JAX's cumprod over [:, ::-1])
    include = torch.flip(
        torch.cumprod(torch.flip(shifted.int(), [1]), dim=1), [1]) > 0
    include = include & below_ld[:, :, 0]
    # construction searches sweep [l_min, l_d]; serving has l_min == 0
    include = include & (lev[:, :, 0] >= st.l_min[:, None])

    elig = unvis & inr & include[:, :, None] & act[:, None, None]  # [B,L,m]
    rank = ((st.l_d[:, None, None] - lev) * m + col).masked_fill(~elig, _BIG)
    if cfg.pipeline == "reference":
        ids_f, rank_f = dedupe_pairwise(nbc.reshape(B, F), rank.reshape(B, F))
        # the K best (smallest) ranks; eligible ranks are injective over
        # slots and every tie is at _BIG (masked below), so the admitted
        # set and its order match ``lax.top_k``'s
        sel_rank, sel_pos = torch.topk(rank_f, K, dim=1, largest=False,
                                       sorted=True)
        sel_valid = sel_rank < _BIG
        sel_ids = torch.gather(ids_f, 1, sel_pos).masked_fill(~sel_valid, 0)
    else:
        ids_f, rank_f = _dedupe_sorted(nbc.reshape(B, F), rank.reshape(B, F),
                                       F)
        sel_ids, sel_rank, sel_valid = _admit(ids_f, rank_f, F, K)

    # ---- mark visited ----
    if probe_cache is None or cfg.pipeline == "reference":
        # bitmap mode, or the oracle pipeline (kept on the rehash path so
        # parity tests exercise cached-vs-recomputed probes)
        _visited_mark(st.vstate, sel_ids, sel_valid, cfg)
    else:
        # reuse the probe positions the visited TEST computed: a selected
        # entry's rank is injective in its (layer, col) slot given l_d —
        # invert it and gather the cached (word, mask) instead of rehashing
        pos = ((st.l_d[:, None] - sel_rank // m) * m
               + sel_rank % m).clamp(0, F - 1)
        w_sel = torch.gather(probe_cache[0].reshape(B, F), 1, pos)
        m_sel = torch.gather(probe_cache[1].reshape(B, F), 1, pos)
        _visited_mark_hash(st.vstate, w_sel, m_sel, sel_valid)
    return sel_ids, sel_valid


def _eval(di: DeviceIndex, idc: torch.Tensor, queries: torch.Tensor,
          cfg: HopCfg):
    """-> (dots, |v|^2) of the clipped candidate ids [B, K]: the fused
    gather kernel (``gather_norm_dot``, dequant in registers), or for the
    reference pipeline a materialized gather + the ``batched_dot`` kernel
    with the cached norms."""
    if cfg.pipeline == "reference":
        return eval_materialized(di.vectors, di.sq_norms, idc, queries,
                                 cfg.backend)
    return gather_norm_dot(di.vectors, idc, queries,
                           scales=_gather_scales(di), backend=cfg.backend)


def _hop_body(di: DeviceIndex, cfg: HopCfg, st: HopState) -> HopState:
    """One iteration of the hop loop over the whole (current) batch.
    Updates ``st.vstate`` in place (an inactive row marks only its trash
    word); every other field is a new tensor."""
    L, n, m = di.neighbors.shape
    W = st.res_d.shape[1]
    K = min(m + 1, L * m)
    dev = st.queries.device
    is_seed = st.t == 0

    if is_seed:
        # entry-point fold: the seed iteration selects exactly {ep}, through
        # the same eval/merge lanes as every other hop (the seed does not
        # count as a hop)
        act = st.active
        res_e2 = st.res_e
        sel_valid = (torch.arange(K, device=dev)[None, :] == 0) & act[:, None]
        sel_ids = st.ep[:, None] * sel_valid
        _visited_mark(st.vstate, sel_ids, sel_valid, cfg)
    else:
        # ---- pop the nearest unexpanded candidate (Alg. 2 line 5) ----
        unexp = st.res_d.masked_fill(st.res_e, _INF)  # [B, W]
        i_star = torch.argmin(unexp, dim=1)  # first minimum, as jnp
        d_star = torch.gather(unexp, 1, i_star[:, None])[:, 0]
        worst = st.res_d[:, W - 1]
        full = st.res_i[:, W - 1] >= 0
        done = (d_star == _INF) | (full & (d_star > worst))
        act = st.active & ~done
        s = torch.gather(st.res_i, 1, i_star[:, None])[:, 0].masked_fill(
            ~act, 0)
        # mark the popped slot expanded (an elementwise compare, so the hop
        # copies nothing from the host and can be captured in a CUDA graph)
        popped = torch.arange(W, device=dev)[None, :] == i_star[:, None]
        res_e2 = torch.where(act[:, None], st.res_e | popped, st.res_e)
        sel_ids, sel_valid = _select_candidates(di, cfg, st, act, s)

    # ---- distance evaluation (the CUDA kernels) ----
    idc = sel_ids.clamp(0, n - 1)
    dots, v2 = _eval(di, idc, st.queries, cfg)
    if cfg.metric == "l2":
        dd = (v2 - 2.0 * dots + st.q2[:, None]).clamp(min=0.0)
    else:
        dd = 1.0 - dots
    dd = dd.masked_fill(~sel_valid, _INF)
    dc2 = st.dc + sel_valid.sum(dim=1)

    # ---- merge into the sorted fixed-width result set ----
    new_i = sel_ids.masked_fill(~sel_valid, -1)
    new_e = ~sel_valid  # invalid entries act as expanded padding
    if cfg.pipeline == "reference":
        nres_d, nres_i, nres_e = merge_full_sort(
            st.res_d, st.res_i, res_e2, dd, new_i, new_e, W
        )
    else:
        nres_d, nres_i, nres_e = _merge_sorted(
            st.res_d, st.res_i, res_e2, dd, new_i, new_e, W, method=cfg.merge
        )

    # ---- commit only for queries that worked this hop ----
    a2 = act[:, None]
    return st._replace(
        res_d=torch.where(a2, nres_d, st.res_d),
        res_i=torch.where(a2, nres_i, st.res_i),
        res_e=torch.where(a2, nres_e, res_e2),
        active=act,
        dc=torch.where(act, dc2, st.dc),
        hops=st.hops if is_seed else st.hops + act.long(),
        t=st.t + 1,
    )


def _run_hops(di: DeviceIndex, st: HopState, cfg: HopCfg, h: int) -> HopState:
    """Run up to ``h`` iterations; stops early when every query terminated
    (one host sync per hop) or at the global cap ``max_hops + 1``, which
    counts the seed."""
    i = 0
    while i < h and st.t < cfg.max_hops + 1 and bool(st.active.any()):
        st = _hop_body(di, cfg, st)
        i += 1
    return st


class _GraphedChunk:
    """``h`` hop iterations captured once as a CUDA graph and replayed.

    The hop loop is host-bound (a few hundred small torch ops per hop, see
    PERF.md), so the compaction driver replays whole chunks instead of
    dispatching their ops one by one.  The graph reads its inputs from
    static copies of a ``HopState`` and the index tensors' fixed addresses
    (part of the cache key), and runs exactly ``h`` hops: a hop after every
    query terminated changes nothing but ``t``, so the results are those of
    the eager ``_run_hops``, which stops at the first all-inactive hop.

    Capturing launches nothing and a replay goes past the kernel wrappers,
    so neither adds to their ``LAUNCHES``; ``GRAPH_REPLAYS`` counts the
    replays and the hops they ran, and ``KERNEL_REPLAYS`` the kernel
    launches those hops replayed (one a hop, of the pipeline's kernel,
    unless the plain versions were captured).  Every graph captures into
    one shared memory pool: the static inputs live outside it and ``run``
    clones the outputs before any other replay can start, so graphs may
    reuse each other's intermediates as long as replays run one at a time
    on one stream, as here."""

    def __init__(self, di: DeviceIndex, cfg: HopCfg, st: HopState, h: int):
        t0 = time.perf_counter()
        self.static = st._replace(**{
            f: getattr(st, f).clone() for f in _STATE_TENSORS})
        GRAPH_CAPTURES["chunks"] += 1
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=_graph_pool()):
            out = self.static
            for _ in range(h):
                out = _hop_body(di, cfg, out)
        self.out = out
        record_event("capture", f"hop chunk h={h} B={st.res_i.shape[0]} "
                     f"k={cfg.k} W={cfg.width} n={di.neighbors.shape[1]}",
                     time.perf_counter() - t0)
        self.h = h
        # the kernel each captured hop launched (graphs exist only on the
        # card, where "auto" is the kernel)
        self.kernel = None if cfg.backend == "ref" else (
            "batched_dot" if cfg.pipeline == "reference"
            else "gather_norm_dot")

    def run(self, st: HopState) -> HopState:
        for f in _STATE_TENSORS:
            getattr(self.static, f).copy_(getattr(st, f))
        self.graph.replay()
        GRAPH_REPLAYS["chunks"] += 1
        GRAPH_REPLAYS["hops"] += self.h
        if self.kernel is not None:
            KERNEL_REPLAYS[self.kernel] += self.h
        # clone: the next replay overwrites the graph's outputs
        return self.out._replace(t=st.t + self.h, **{
            f: getattr(self.out, f).clone() for f in _STATE_TENSORS})


_STATE_TENSORS = tuple(f for f in HopState._fields if f != "t")
GRAPH_REPLAYS = {"chunks": 0, "hops": 0}  # replays and the hops they ran
GRAPH_CAPTURES = {"chunks": 0}  # chunks captured (a capture launches nothing)
# kernel launches replayed by captured hops, by kernel (the fused
# pipeline's and the reference pipeline's)
KERNEL_REPLAYS = {"gather_norm_dot": 0, "batched_dot": 0}
_GRAPH_CACHE: dict = {}  # key -> _GraphedChunk, or None once seen
_GRAPH_CACHE_SIZE = 128
_GRAPH_POOL = None  # the memory pool every captured chunk shares


def _graph_pool():
    global _GRAPH_POOL
    if _GRAPH_POOL is None:
        _GRAPH_POOL = torch.cuda.graph_pool_handle()
    return _GRAPH_POOL


def graph_cache_stats() -> dict:
    """Captured chunks held by the cache, the chunks captured so far
    (``captures``, cumulative) and the device bytes their shared pool has
    reserved (0 before the first capture)."""
    pool = _GRAPH_POOL
    nbytes = 0
    if pool is not None:
        nbytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
    return {"graphs": sum(c is not None for c in _GRAPH_CACHE.values()),
            "captures": GRAPH_CAPTURES["chunks"], "pool_bytes": nbytes}


def _graph_key(di: DeviceIndex, cfg: HopCfg, st: HopState, h: int):
    def sig(t):
        return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)

    return (h, cfg, tuple(sig(t) for t in di),
            tuple((tuple(getattr(st, f).shape), getattr(st, f).dtype)
                  for f in _STATE_TENSORS))


def _run_chunk(di: DeviceIndex, st: HopState, cfg: HopCfg, h: int) -> HopState:
    """One chunk of the compaction driver: on the card, a captured CUDA
    graph of ``h`` hops from a shape's second chunk on (the first runs
    eagerly, which also warms every op up for the capture, and a shape
    seen once is never captured); ``_run_hops`` elsewhere, for the seed
    iteration and where the global cap would end the chunk early.  The
    cache keeps the ``_GRAPH_CACHE_SIZE`` most recently used shapes."""
    if (not st.res_i.is_cuda or st.t < 1
            or st.t + h > cfg.max_hops + 1):
        return _run_hops(di, st, cfg, h)
    key = _graph_key(di, cfg, st, h)
    if key not in _GRAPH_CACHE:
        if len(_GRAPH_CACHE) >= _GRAPH_CACHE_SIZE:
            del _GRAPH_CACHE[next(iter(_GRAPH_CACHE))]  # oldest first
        _GRAPH_CACHE[key] = None
        return _run_hops(di, st, cfg, h)
    chunk = _GRAPH_CACHE.pop(key)  # re-insert: most recently used last
    if chunk is None:
        chunk = _GraphedChunk(di, cfg, st, h)
    _GRAPH_CACHE[key] = chunk
    return chunk.run(st)


def _compact_rows(st: HopState, idx: torch.Tensor, act_n: int) -> HopState:
    """Gather surviving rows into the next bucket (rows >= act_n are
    padding duplicates, forced inactive)."""
    take = lambda a: a.index_select(0, idx)  # noqa: E731
    act = torch.arange(idx.shape[0], device=idx.device) < act_n
    return HopState(
        queries=take(st.queries), q2=take(st.q2), x=take(st.x), y=take(st.y),
        l_d=take(st.l_d), l_min=take(st.l_min), ep=take(st.ep),
        res_d=take(st.res_d), res_i=take(st.res_i), res_e=take(st.res_e),
        vstate=take(st.vstate), active=take(st.active) & act,
        dc=take(st.dc), hops=take(st.hops), t=st.t,
    )


def _drive_chunked(di, st: HopState, cfg: HopCfg, compact: tuple[int, int],
                   B: int, t0: int):
    """Ragged-batch compaction driver over an initialised ``HopState`` of
    ``Bp >= B`` rows (rows >= B are padding and must be inactive).

    Phase 1 runs ``compact[0]`` iterations on the full bucket; every later
    phase compacts the still-active queries into the next bucket
    (``_bucket_ceil``) and runs ``compact[1]`` more, each chunk a replayed
    CUDA graph on the card (``_run_chunk``).  Finished queries are
    harvested at chunk boundaries, where ``active`` is read to the host
    (the chunk-boundary sync).  ``t0`` is the state's initial iteration
    counter.  Returns host ``(ids[B, k], dists[B, k], dc[B], hops[B])``.
    """
    h0, h1 = compact
    k = cfg.k
    out_i = np.full((B, k), -1, np.int32)
    out_d = np.full((B, k), np.inf, np.float32)
    out_dc = np.zeros(B, np.int32)
    out_hops = np.zeros(B, np.int32)
    if B == 0:
        return out_i, out_d, out_dc, out_hops
    Bp = st.res_i.shape[0]
    orig = np.concatenate([np.arange(B), np.full(Bp - B, B)])  # B = sentinel

    h = h0
    t_planned = t0  # upper bound on st.t, tracked host-side
    harvests = []  # (dst rows, bucket rows, result tensors), read post-loop
    while True:
        st = _run_chunk(di, st, cfg, h)
        t_planned += h
        act = st.active.cpu().numpy()  # the chunk-boundary sync point
        real = orig < B
        live = np.flatnonzero(act & real)
        stop = live.size == 0 or t_planned >= cfg.max_hops + 1
        leave = np.flatnonzero(real if stop else (~act & real))
        if leave.size:  # keep only the result tensors alive, not the state
            harvests.append(
                (orig[leave], leave, st.res_i, st.res_d, st.dc, st.hops))
        if stop:
            break
        Bn = _bucket_ceil(live.size)
        if Bn < len(orig):  # bucket shrinks: gather the survivors
            idx = np.concatenate([live, np.full(Bn - live.size, live[0])])
            st = _compact_rows(
                st, torch.as_tensor(idx, device=st.res_i.device), live.size)
            orig = np.where(np.arange(Bn) < live.size, orig[idx], B)
        else:  # same bucket: skip the gather, just retire harvested rows
            orig[leave] = B
        h = h1
    for dst, rows_, res_i, res_d, dc_, hops_ in harvests:
        out_i[dst] = res_i.cpu().numpy()[rows_, :k]
        out_d[dst] = res_d.cpu().numpy()[rows_, :k]
        out_dc[dst] = dc_.cpu().numpy()[rows_]
        out_hops[dst] = hops_.cpu().numpy()[rows_]
    return out_i, out_d, out_dc, out_hops


def _search_whole(di, queries, ranges, cfg: HopCfg) -> SearchResult:
    """Lock-step path: init + one full-length hop loop."""
    st = _init_state(di, queries, ranges, cfg)
    st = _run_hops(di, st, cfg, cfg.max_hops + 1)
    return SearchResult(
        ids=st.res_i[:, : cfg.k].cpu().numpy().astype(np.int32),
        dists=st.res_d[:, : cfg.k].cpu().numpy(),
        dc=st.dc.cpu().numpy().astype(np.int32),
        hops=st.hops.cpu().numpy().astype(np.int32),
    )


def _search_chunked(di, queries, ranges, cfg: HopCfg,
                    compact: tuple[int, int]) -> SearchResult:
    """Serving entry of the compaction driver: pad, init, drive."""
    B = queries.shape[0]
    if B == 0:
        return SearchResult(
            ids=np.full((0, cfg.k), -1, np.int32),
            dists=np.full((0, cfg.k), np.inf, np.float32),
            dc=np.zeros(0, np.int32), hops=np.zeros(0, np.int32),
        )
    qp, rp = pad_queries(queries, ranges)
    st = _init_state(di, qp, rp, cfg)
    return SearchResult(*_drive_chunked(di, st, cfg, compact, B, 0))


def _init_build_state(di: DeviceIndex, queries, ranges, eps, l_lo, l_hi,
                      seed_i, seed_d, valid, cfg: HopCfg) -> HopState:
    """Construction-search init: entry/landing override + carry-seeded beams.

    Unlike the serving ``_init_state`` the caller supplies everything the
    snapshot's unique-value tables would otherwise derive: the layer span
    ``[l_lo, l_hi]`` (insertion layer up to the top, Alg. 1 line 5), the
    host-sampled window entry ``eps`` (Alg. 1 line 7) and the Thm-3.1 carry
    ``(seed_i, seed_d)`` — already-evaluated candidates whose distances are
    known, so they preload the beam with no DC and no re-discovery hops.
    Members with a non-empty carry skip the entry evaluation; the rest
    evaluate their entry here (the hop-0 fold, hoisted out of the loop),
    and the state starts at ``t = 1`` so ``_hop_body`` never runs its seed
    iteration.  ``queries`` are prepared (cosine-normalised) rows."""
    B, _ = queries.shape
    L, n, m = di.neighbors.shape
    W = max(cfg.width, cfg.k)
    dev = queries.device
    queries = queries.float()
    q2 = _row_sq(queries)
    ranges = ranges.float()
    # carry sorted ascending by distance (stable; invalid lanes +inf), the
    # nearest W preloading the beam — exactly the host path's preload
    seed_i = seed_i.long()
    sd = torch.where(seed_i >= 0, seed_d.float(), _INF)
    sd_s, order = torch.sort(sd, dim=1, stable=True)
    si_s = torch.gather(seed_i, 1, order)
    S = min(seed_i.shape[1], W)
    res_d = torch.full((B, W), _INF, device=dev)
    res_d[:, :S] = sd_s[:, :S]
    res_i = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    res_i[:, :S] = torch.where(torch.isfinite(sd_s[:, :S]), si_s[:, :S],
                               torch.full_like(si_s[:, :S], -1))
    has_seed = res_i[:, 0] >= 0
    epc = eps.long().clamp(0, n - 1)
    dots, v2 = _eval(di, epc[:, None], queries, cfg)
    if cfg.metric == "l2":
        d_ep = (v2[:, 0] - 2.0 * dots[:, 0] + q2).clamp(min=0.0)
    else:
        d_ep = 1.0 - dots[:, 0]
    use_ep = valid & ~has_seed
    res_d[:, 0] = torch.where(use_ep, d_ep, res_d[:, 0])
    res_i[:, 0] = torch.where(use_ep, epc, res_i[:, 0])
    res_e = res_i < 0  # valid entries unexpanded; padding reads expanded
    v_words = ((n + 31) // 32) if cfg.visited == "bitmap" else cfg.v_words
    vstate = torch.zeros((B, v_words + 1), dtype=torch.int64, device=dev)
    # mark exactly the preloaded beam (kept seeds + entries), as the host
    # does; the carry is id-deduped, so the bitmap's add is an OR
    vstate = _visited_mark(vstate, res_i.clamp(min=0), res_i >= 0, cfg)
    return HopState(
        queries=queries,
        q2=q2,
        x=ranges[:, 0],
        y=ranges[:, 1],
        l_d=l_hi.long(),
        l_min=l_lo.long(),
        ep=epc,
        res_d=res_d,
        res_i=res_i,
        res_e=res_e,
        vstate=vstate,
        active=valid,
        dc=use_ep.long(),  # the entry evaluation, host-identical
        hops=torch.zeros(B, dtype=torch.int64, device=dev),
        t=1,  # the entry fold already happened: skip the seed hop
    )


def _build_search_core(di, queries, ranges, eps, l_lo, l_hi, seed_i, seed_d,
                       valid, cfg):
    """Init + lock-step hop loop of one construction search (every
    per-member trajectory is row-independent).  -> device
    ``(res_i, res_d, dc, hops)``."""
    st = _init_build_state(di, queries, ranges, eps, l_lo, l_hi, seed_i,
                           seed_d, valid, cfg)
    st = _run_hops(di, st, cfg, cfg.max_hops + 1)
    return st.res_i, st.res_d, st.dc, st.hops


class _BuildPrep(NamedTuple):
    """Device-ready construction-search inputs (see ``_prep_build_inputs``):
    ``args`` is the positional tuple ``_build_search_core`` consumes after
    ``di`` (targets, ranges, eps, lo, hi, seed ids/dists, valid)."""

    di: DeviceIndex  # layer-span-sliced view
    args: tuple
    cfg: HopCfg
    B: int  # real (unpadded) member count


def _prep_build_inputs(
    di: DeviceIndex,
    targets: np.ndarray,
    ranges: np.ndarray,
    eps: np.ndarray,
    l_lo: int,
    l_hi: int,
    seed_ids: np.ndarray | None,
    seed_d: np.ndarray | None,
    *,
    width: int,
    m: int,
    o: int,
    metric: str,
    seed_width: int | None,
    backend: str,
    visited: str,
    visited_bits: int | None,
    visited_fp: float,
    visited_hashes: int,
    merge: str,
    max_hops: int | None,
    multiple: int = 1,
) -> _BuildPrep:
    """Host-side prep of one construction search, shared by ``build_search``
    and the sharded build (``core.distributed.sharded_build_search``): seed
    truncation, pow2 batch padding (rounded up to ``multiple`` so the batch
    divides a build mesh), static config, and the layer-span slice of the
    neighbor tensor.  Per-member trajectories are independent of the
    padded batch size."""
    targets = np.asarray(targets, np.float32)
    B = targets.shape[0]
    W = int(width)
    if max_hops is None:
        max_hops = _default_max_hops(W)
    C = int(seed_width) if seed_width else (
        seed_ids.shape[1] if seed_ids is not None and seed_ids.ndim == 2 else 0
    )
    # the init keeps only the W nearest seeds (the host preload's S =
    # min(C, W)); truncating host-side shrinks the device-side seed sort
    # from the full carry width to W
    if seed_ids is not None and seed_ids.ndim == 2 and seed_ids.shape[1] > W:
        so = np.argsort(
            np.where(seed_ids >= 0, seed_d, np.inf), axis=1, kind="stable"
        )[:, :W]
        seed_ids = np.take_along_axis(seed_ids, so, 1)
        seed_d = np.take_along_axis(seed_d, so, 1)
    C = max(min(C, W), 1)
    Bp = _pow2ceil(max(B, _MIN_BUCKET))
    if multiple > 1 and Bp % multiple:
        Bp = -(-Bp // multiple) * multiple  # round up to the mesh size
    si = np.full((Bp, C), -1, np.int64)
    sdp = np.full((Bp, C), np.inf, np.float32)
    if seed_ids is not None and seed_ids.size:
        S = min(seed_ids.shape[1], C)
        si[:B, :S] = seed_ids[:, :S]
        sdp[:B, :S] = seed_d[:, :S]
    tp = np.zeros((Bp, targets.shape[1]), np.float32)
    tp[:B] = targets
    rp = np.zeros((Bp, 2), np.float32)
    rp[:B] = np.asarray(ranges, np.float32)
    rp[B:] = (1.0, 0.0)
    ep = np.zeros(Bp, np.int64)
    ep[:B] = np.asarray(eps, np.int64)
    valid = np.arange(Bp) < B
    v_words = 0
    if visited == "hash":
        if visited_bits is None:
            visited_bits = visited_filter_bits(
                W, m, max_hops, fp=visited_fp, hashes=visited_hashes
            )
        else:
            visited_bits = _pow2ceil(max(int(visited_bits), 1024))
        v_words = visited_bits // 32
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; registered: "
                         f"{BACKENDS}")
    cfg = HopCfg(
        k=W, width=W, m=m, o=o, metric=metric, max_hops=int(max_hops),
        backend=backend, pipeline="fused", visited=visited,
        v_words=v_words, v_hashes=int(visited_hashes), merge=merge,
    )
    # layer-span slicing: a search over [l_lo, l_hi] only ever gathers
    # those layers' rows, so slice the neighbor tensor to a pow2-quantised
    # span ending at l_hi (extra lower layers are masked by l_min) — the
    # per-hop sort/mask width then scales with the sweep, not the full
    # layer count
    L_all = di.neighbors.shape[0]
    span_q = min(_pow2ceil(int(l_hi) - int(l_lo) + 1), int(l_hi) + 1)
    base = int(l_hi) + 1 - span_q
    if base > 0 or span_q < L_all:
        di = di._replace(neighbors=di.neighbors[base : int(l_hi) + 1])
    lo = np.full(Bp, int(l_lo) - base, np.int64)
    hi = np.full(Bp, int(l_hi) - base, np.int64)
    dev = di.vectors.device

    def _t(a):
        return torch.from_numpy(a).to(dev)

    args = (_t(tp), _t(rp), _t(ep), _t(lo), _t(hi), _t(si), _t(sdp),
            _t(valid))
    return _BuildPrep(di=di, args=args, cfg=cfg, B=B)


def _finish_build_search(
    res_i, res_d, dc, hops, B: int, deleted: set[int] | None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Device->host readback of one construction search (the one sync per
    (micro-batch, layer) beyond the hop loop's own): strip the batch
    padding and mask deleted ids to -1 (they stay traversable in-loop,
    §3.7), mirroring ``search_candidates_batch``'s contract."""

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    res_i = host(res_i)[:B].astype(np.int32)
    res_d = host(res_d)[:B]
    dc = host(dc)[:B].astype(np.int32)
    hops = host(hops)[:B].astype(np.int32)
    if deleted:
        dead = (res_i >= 0) & np.isin(
            res_i, np.fromiter(deleted, dtype=np.int64, count=len(deleted))
        )
        res_i = np.where(dead, -1, res_i)
    return res_i, res_d, dc, hops


def build_search(
    di: DeviceIndex,
    targets: np.ndarray,
    ranges: np.ndarray,
    eps: np.ndarray,
    l_lo: int,
    l_hi: int,
    seed_ids: np.ndarray | None,
    seed_d: np.ndarray | None,
    *,
    width: int,
    m: int,
    o: int,
    metric: str = "l2",
    seed_width: int | None = None,
    deleted: set[int] | None = None,
    backend: str = "auto",
    visited: str = "hash",
    visited_bits: int | None = None,
    visited_fp: float = 0.02,
    visited_hashes: int = 2,
    merge: str = "auto",
    max_hops: int | None = None,
    compact: tuple[int, int] | None = (8, 8),
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One micro-batch per-layer candidate search on the device pipeline —
    the device-resident replacement for the host ``search_candidates_batch``
    during batched builds.

    ``targets`` [B, d] are prepared member vectors, ``ranges`` [B, 2] the
    per-member layer windows, ``eps`` [B] host-sampled entries (used only by
    members with an empty carry) and ``(seed_ids, seed_d)`` the Thm-3.1
    carry.  ``B`` is padded to a power-of-two bucket.  ``compact`` (default
    ``(8, 8)``) runs the hop loop as resumable chunks with ragged-batch
    compaction between them — carry-seeded members finish in a handful of
    hops, so harvesting them early keeps the lock-step loop from running
    every member at the straggler's pace; ``None`` = one lock-step loop.
    Returns host ``(res_i, res_d, dc, hops)`` with deleted ids masked to -1.
    """
    prep = _prep_build_inputs(
        di, targets, ranges, eps, l_lo, l_hi, seed_ids, seed_d,
        width=width, m=m, o=o, metric=metric, seed_width=seed_width,
        backend=backend, visited=visited, visited_bits=visited_bits,
        visited_fp=visited_fp, visited_hashes=visited_hashes, merge=merge,
        max_hops=max_hops,
    )
    if compact is None:
        out = _build_search_core(prep.di, *prep.args, prep.cfg)
    else:
        st = _init_build_state(prep.di, *prep.args, prep.cfg)
        out = _drive_chunked(
            prep.di, st, prep.cfg, (int(compact[0]), int(compact[1])),
            prep.B, 1,
        )
    return _finish_build_search(*out, prep.B, deleted)


def pad_queries(queries: torch.Tensor, ranges: torch.Tensor):
    """Pad a batch up to its power-of-two bucket (at least 8 rows) with zero
    queries and an inverted (empty) range [1, 0], so pad rows are inactive
    from init and cost no hops."""
    B = queries.shape[0]
    Bp = _pow2ceil(max(B, _MIN_BUCKET))
    if Bp == B:
        return queries, ranges
    qp = torch.zeros((Bp, queries.shape[1]), dtype=torch.float32,
                     device=queries.device)
    qp[:B] = queries
    rp = torch.tensor([1.0, 0.0], device=ranges.device).repeat(Bp, 1)
    rp[:B] = ranges
    return qp, rp


def hop_cfg(
    *,
    k: int = 10,
    width: int = 64,
    m: int = 16,
    o: int = 4,
    metric: str = "l2",
    max_hops: int | None = None,
    backend: str = "auto",
    pipeline: str = "fused",
    visited: str = "bitmap",
    visited_bits: int | None = None,
    visited_fp: float = 0.02,
    visited_hashes: int = 2,
    merge: str = "auto",
) -> HopCfg:
    """Resolve user-facing serving knobs into the static ``HopCfg``: beam
    width floored at k, the default global hop budget, hash filter sizing
    (budget-derived when ``visited_bits`` is None, pow2 floor otherwise)."""
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if visited not in ("bitmap", "hash"):
        raise ValueError(f"unknown visited filter {visited!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; registered: "
                         f"{BACKENDS}")
    if merge not in MERGE_METHODS:
        raise ValueError(f"unknown writeback method {merge!r}")
    W = max(width, k)
    if max_hops is None:
        max_hops = _default_max_hops(W)
    v_words = 0
    if visited == "hash":
        if visited_bits is None:
            visited_bits = visited_filter_bits(
                W, m, max_hops, fp=visited_fp, hashes=visited_hashes
            )
        else:
            visited_bits = _pow2ceil(max(int(visited_bits), 1024))
        v_words = visited_bits // 32
    return HopCfg(
        k=k, width=W, m=m, o=o, metric=metric, max_hops=int(max_hops),
        backend=backend, pipeline=pipeline, visited=visited,
        v_words=v_words, v_hashes=int(visited_hashes), merge=merge,
    )


def device_search(
    di: DeviceIndex,
    queries,  # f32[B, d] (numpy or tensor)
    ranges,  # f32[B, 2]
    *,
    k: int = 10,
    width: int = 64,
    m: int = 16,
    o: int = 4,
    metric: str = "l2",
    max_hops: int | None = None,
    backend: str = "auto",
    pipeline: str = "fused",
    visited: str = "bitmap",
    visited_bits: int | None = None,
    visited_fp: float = 0.02,
    visited_hashes: int = 2,
    merge: str = "auto",
    compact: tuple[int, int] | None = None,
) -> SearchResult:
    """Batched device search on the device holding ``di``; see the module
    docstring for the ``pipeline``/``visited``/``compact``/``merge``
    semantics.  Returns host arrays."""
    if pipeline == "reference" and di.vectors.dtype != torch.float32:
        # the oracle pipeline materializes di.vectors [B, K, d] and reads
        # di.sq_norms directly — it has no dequant stage by design (f32 is
        # the parity oracle; quantized modes are gated against it instead)
        raise ValueError(
            "pipeline='reference' requires an f32 vector slab; quantized "
            f"snapshots (dtype {di.vectors.dtype}) serve via pipeline='fused'"
        )
    cfg = hop_cfg(
        k=k, width=width, m=m, o=o, metric=metric, max_hops=max_hops,
        backend=backend, pipeline=pipeline, visited=visited,
        visited_bits=visited_bits, visited_fp=visited_fp,
        visited_hashes=visited_hashes, merge=merge,
    )
    dev = di.vectors.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    ranges = torch.as_tensor(ranges, dtype=torch.float32, device=dev)
    if compact is None:
        return _search_whole(di, queries, ranges, cfg)
    return _search_chunked(di, queries, ranges, cfg,
                           (int(compact[0]), int(compact[1])))


def search_batch(
    snap: Snapshot,
    queries: np.ndarray,
    ranges: np.ndarray,
    k: int = 10,
    width: int = 64,
    backend: str = "auto",
    pipeline: str = "fused",
    visited: str = "bitmap",
    visited_bits: int | None = None,
    compact: tuple[int, int] | None = None,
    pad_batch: bool = True,
    max_hops: int | None = None,
    vec_dtype: str | None = None,
    device=None,
) -> SearchResult:
    """Convenience host wrapper: snapshot -> device tensors -> search.

    ``pad_batch`` pads B up to the next power-of-two bucket (padding
    rows carry an empty range, so they are inactive from init and cost no
    hops), the batch shapes the serving path runs at.  ``max_hops`` caps
    the global hop budget below the width-derived default (a truncated
    search returns the best-so-far beam).  ``vec_dtype`` selects the device
    slab storage mode (see ``to_device_index``).  ``device=None`` is the
    CUDA card."""
    di = to_device_index(snap, vec_dtype=vec_dtype, device=device)
    dev = di.vectors.device
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    r = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    B = q.shape[0]
    if pad_batch:
        q, r = pad_queries(q, r)
    res = device_search(
        di, q, r, k=k, width=width, m=snap.m, o=snap.o,
        metric="l2" if snap.metric == "l2" else "cosine",
        max_hops=max_hops, backend=backend, pipeline=pipeline,
        visited=visited, visited_bits=visited_bits, compact=compact,
    )
    return SearchResult(*(a[:B] for a in res))


def compare_results(a: SearchResult, b: SearchResult, rtol: float = 1e-5,
                    scale: float = 0.0) -> dict:
    """Hold two searches of the same queries to each other under the tie
    rule: ``ids``, ``dc`` and ``hops`` equal per query and ``dists`` within
    ``rtol * (|d| + scale)``; a query that differs is a *tie flip* only if
    the two distances at its first differing id slot agree within that
    bound (a reordering of (near-)equal distances by float summation
    order).  ``scale`` bounds the magnitude of the terms a distance is
    formed from (``|v|^2 + |q|^2`` for l2, whose factorised form cancels
    them, so its rounding error scales with them and not with ``d``; 2 for
    cosine).  Returns ``{"queries", "tie_flips", "faults"}`` with the row
    lists."""
    ai, bi = np.asarray(a.ids), np.asarray(b.ids)
    ad, bd = np.asarray(a.dists), np.asarray(b.dists)

    def close(x, y):
        return np.isclose(x, y, rtol=rtol, atol=rtol * scale)

    flips, faults = [], []
    for r in range(ai.shape[0]):
        same = (np.array_equal(ai[r], bi[r]) and a.dc[r] == b.dc[r]
                and a.hops[r] == b.hops[r])
        if same:
            if not close(ad[r], bd[r]).all():
                faults.append(r)
            continue
        diff = np.flatnonzero(ai[r] != bi[r])
        if diff.size and close(ad[r, diff[0]], bd[r, diff[0]]):
            flips.append(r)
        else:
            faults.append(r)
    return {"queries": int(ai.shape[0]), "tie_flips": flips,
            "faults": faults}
