"""Frozen device snapshot of a WoW index + the build-path delta arena.

The writer (host arenas, ``WoWIndex``) and the reader (device batched search)
are split: serving takes an immutable snapshot — padded dense tensors that
device code can gather from.  Deleted vertices are compacted out (the device
path serves snapshots; traversal-through-deleted is a host-path property that
matters only between prunes).

Arrays (n = live vertices, L = layers, m = max outdegree):

  vectors      f32[n, d]
  sq_norms     f32[n]
  attrs        f32[n]
  neighbors    i32[L, n, m]       (-1 padded; ids re-mapped post-compaction)
  uvals        f32[u]             sorted unique attribute values
  uval_rep     i32[u]             representative (first live) vertex per value
  ids_map      i64[n]             snapshot id -> original WoWIndex id

Quantized serving (``vec_dtype`` = "int8" | "bf16") adds optional slabs:

  q_vectors    int8[n, d] / uint16[n, d] storage-dtype vector slab (bf16
                                          as its uint16 bit pattern)
  q_scales     f32[n]                     per-row dequant scales (int8 only)

``vectors`` stays the f32 oracle copy; ``to_device_index`` prefers the
pre-quantized slabs (checkpoint cold start) and re-derives them from
``vectors`` otherwise.  Quantization is per-row (``core.store.quantize_rows``)
so both routes are bitwise identical.

Incremental refresh: ``take_snapshot(index, prev=...)`` reuses the previous
snapshot's arrays when nothing was deleted and the index tracked which
neighbor rows changed since ``prev`` was taken (``WoWIndex`` keeps a dirty-row
tracker fed by the batched commit): unchanged row prefixes are block-copied,
changed rows are re-read from the graph arena, and the sorted unique-value
arrays are merged instead of re-sorted — the serve-refresh path for
ingest-while-serve skips the [L, n, m] re-compaction argsort entirely.

Build-path delta arena:

  * ``NeighborSlab`` — the persistent host twin of the per-batch
    ``np.stack`` slab that ``search_candidates_batch`` gathers from: one
    top-down ``i32[cap, (top+1)*m]`` arena, allocated at graph capacity and
    maintained by scattering only the (layer, vertex) rows each micro-batch
    committed.  Re-built in full only when the graph itself reallocates
    (capacity/top growth — amortised) or when a mutation bypassed the delta
    protocol (detected via ``LayeredGraph.version``).

The device-resident build arenas of the reference (``DeviceBuildArena``,
``ShardedBuildArena``) come with the device build (ROADMAP A5, A8).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _pow2ceil(x: int) -> int:
    """Next power of two >= x (local twin of the device_search helper —
    importing it here would cycle snapshot <-> device_search)."""
    return 1 << max(0, (int(x) - 1)).bit_length()


def writable(arr: np.ndarray) -> np.ndarray:
    """Copy-on-first-mutation guard for checkpoint-cold-start slabs.

    ``load_serving_snapshot`` wraps ``np.load(mmap_mode="r")`` arrays into
    the ``Snapshot`` **as-is** — they are read-only, and ``np.asarray`` on
    a dtype-matching read-only array aliases it rather than copying.  Any
    consumer about to write a snapshot-derived array in place must route
    the base through this helper first: a no-op for ordinary writable
    arrays, a materializing copy for the read-only mapping (paid once, at
    first mutation, instead of eagerly at cold start).
    """
    a = np.asarray(arr)
    return a if a.flags.writeable else a.copy()


@dataclass(frozen=True)
class Snapshot:
    vectors: np.ndarray
    sq_norms: np.ndarray
    attrs: np.ndarray
    neighbors: np.ndarray
    uvals: np.ndarray
    uval_rep: np.ndarray
    ids_map: np.ndarray
    m: int
    o: int
    metric: str
    stamp: int = -1  # index.mutations at creation (incremental-refresh key)
    q_vectors: np.ndarray | None = None  # storage-dtype slab (int8/bf16)
    q_scales: np.ndarray | None = None  # f32 per-row scales (int8 only)
    vec_dtype: str = "f32"  # storage mode of q_vectors ("f32" = none)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def num_layers(self) -> int:
        return self.neighbors.shape[0]


def _reset_tracker(index, stamp: int) -> None:
    tracker = getattr(index, "_snap_tracker", None)
    if tracker is not None:
        tracker["stamp"] = stamp
        tracker["all"] = False
        tracker["dirty"] = {}


def _fast_refresh_ok(index, prev: Snapshot | None) -> bool:
    """The incremental path applies only when ``prev`` is an identity-mapped
    snapshot of this index's dirty-tracking epoch and nothing is deleted
    (delete compaction remaps every id — a full rebuild by definition)."""
    tracker = getattr(index, "_snap_tracker", None)
    return (
        prev is not None
        and tracker is not None
        and not tracker["all"]
        and prev.stamp == tracker["stamp"]
        and not index.deleted
        and prev.n <= index.store.n
        and prev.num_layers <= index.graph.num_layers
        and prev.m == index.graph.m
        and prev.ids_map.size == prev.n
        and int(prev.ids_map[0]) == 0
        and int(prev.ids_map[-1]) == prev.n - 1
    )


def _refresh_snapshot(index, prev: Snapshot) -> Snapshot:
    """Delta refresh of an identity-mapped snapshot: block-copy the
    unchanged prefix, re-read dirty + tail rows from the graph arena (rows
    are left-compacted by construction, so no per-row argsort), and merge
    the new unique values into the sorted ``uvals`` arrays."""
    store, graph = index.store, index.graph
    n = store.n
    pn = prev.n
    L1 = graph.num_layers
    Lp = prev.num_layers
    m = graph.m

    neighbors = np.empty((L1, n, m), dtype=np.int32)
    neighbors[:Lp, :pn] = prev.neighbors
    for l in range(Lp, L1):  # layers raised since prev: copy whole prefix
        neighbors[l, :pn] = graph.layers[l][:pn]
    for l in range(L1):  # appended tail rows
        neighbors[l, pn:] = graph.layers[l][pn:n]
    dirty = getattr(index, "_snap_tracker")["dirty"]
    for l, parts in dirty.items():
        if l >= Lp or not parts:
            continue  # full-copied above
        rows = np.unique(np.concatenate([np.asarray(p) for p in parts]))
        rows = rows[rows < pn]
        if rows.size:
            neighbors[l, rows] = graph.layers[l][rows]

    vectors = np.concatenate([prev.vectors, store.vectors[pn:n]])
    sq_norms = np.concatenate([prev.sq_norms, store.sq_norms[pn:n]])
    attrs = np.concatenate(
        [prev.attrs, store.attrs[pn:n].astype(np.float32)]
    )

    # merge the tail's unique values into the sorted (uvals, uval_rep):
    # stable sort of the tail -> first (lowest-id) occurrence per new value;
    # values already present keep their (lower-id) representative.
    tail = attrs[pn:]
    if tail.size:
        order = np.argsort(tail, kind="stable")
        sa = tail[order]
        uniq = np.ones(sa.size, dtype=bool)
        uniq[1:] = sa[1:] != sa[:-1]
        tv = sa[uniq]
        trep = (order[uniq] + pn).astype(np.int32)
        pos = np.searchsorted(prev.uvals, tv)
        safe = np.minimum(pos, prev.uvals.size - 1)
        exists = (pos < prev.uvals.size) & (prev.uvals[safe] == tv)
        tv, trep, pos = tv[~exists], trep[~exists], pos[~exists]
        uvals = np.insert(prev.uvals, pos, tv)
        uval_rep = np.insert(prev.uval_rep, pos, trep)
    else:
        uvals, uval_rep = prev.uvals, prev.uval_rep

    stamp = getattr(index, "mutations", -1)
    snap = Snapshot(
        vectors=vectors,
        sq_norms=sq_norms,
        attrs=attrs,
        neighbors=neighbors,
        uvals=uvals,
        uval_rep=uval_rep,
        ids_map=np.arange(n, dtype=np.int64),
        m=m,
        o=index.params.o,
        metric=index.params.metric,
        stamp=stamp,
    )
    _reset_tracker(index, stamp)
    return snap


def take_snapshot(index, prev: Snapshot | None = None) -> Snapshot:
    """Build a compacted snapshot from a live ``WoWIndex``.

    With ``prev`` (a snapshot of the same index) the refresh is incremental
    when possible — no deletes outstanding and the index's dirty-row tracker
    still covers the interval since ``prev`` — and falls back to the full
    rebuild otherwise.  Either way the result is bitwise identical to a
    from-scratch snapshot."""
    if _fast_refresh_ok(index, prev):
        return _refresh_snapshot(index, prev)
    n_all = index.store.n
    deleted = index.deleted
    live = np.asarray([i for i in range(n_all) if i not in deleted], dtype=np.int64)
    n = len(live)
    if n == 0:
        raise ValueError("cannot snapshot an empty index")
    remap = np.full(n_all, -1, dtype=np.int32)
    remap[live] = np.arange(n, dtype=np.int32)

    vectors = index.store.vectors[live].astype(np.float32)
    sq_norms = index.store.sq_norms[live].astype(np.float32)
    attrs = index.store.attrs[live].astype(np.float32)

    L = index.graph.num_layers
    m = index.graph.m
    rows = np.stack([lay[live] for lay in index.graph.layers])  # [L, n, m]
    mapped = np.where(rows >= 0, remap[np.maximum(rows, 0)], -1)
    # left-compact every row so padding is trailing: a stable argsort of the
    # "is padding" mask keeps live entries in order and pushes -1s right —
    # one vectorised pass over [L, n, m] instead of an O(L*n) Python loop
    # (this is the serve-refresh hot path for ingest-while-serve).
    order = np.argsort(mapped < 0, axis=2, kind="stable")
    neighbors = np.take_along_axis(mapped, order, axis=2).astype(np.int32)

    # unique values over live vertices + representative vertex per value
    order = np.argsort(attrs, kind="stable")
    sorted_attrs = attrs[order]
    uniq_mask = np.ones(n, dtype=bool)
    uniq_mask[1:] = sorted_attrs[1:] != sorted_attrs[:-1]
    uvals = sorted_attrs[uniq_mask].astype(np.float32)
    uval_rep = order[uniq_mask].astype(np.int32)

    stamp = getattr(index, "mutations", -1)
    _reset_tracker(index, stamp)
    return Snapshot(
        vectors=vectors,
        sq_norms=sq_norms,
        attrs=attrs,
        neighbors=neighbors,
        uvals=uvals,
        uval_rep=uval_rep,
        ids_map=live,
        m=m,
        o=index.params.o,
        metric=index.params.metric,
        stamp=stamp,
    )


def snapshot_from_arrays(
    vectors: np.ndarray,
    sq_norms: np.ndarray,
    attrs: np.ndarray,
    neighbors: np.ndarray,
    deleted: np.ndarray,
    m: int,
    o: int,
    metric: str,
    stamp: int = -1,
    q_vectors: np.ndarray | None = None,
    q_scales: np.ndarray | None = None,
    vec_dtype: str = "f32",
) -> Snapshot:
    """Build a serving ``Snapshot`` straight from checkpoint slabs — the
    serve-from-checkpoint cold start (the reference's ``repro.persist``;
    persistence is ROADMAP A6 in this package), no live index.

    ``vectors``/``sq_norms``/``neighbors`` may be memory-mapped arrays
    (``np.load(mmap_mode="r")``): with no tombstones they are wrapped
    as-is — graph rows are left-compacted by construction, exactly the
    snapshot layout — so serving starts before the slabs are paged in.
    The wrapped arrays are READ-ONLY; consumers must treat every
    ``Snapshot`` field as immutable and route any in-place rewrite of a
    derived array through ``writable()`` (copy-on-first-mutation) —
    ``np.asarray`` on a dtype-matching field aliases the read-only
    mapping instead of copying.
    With tombstones outstanding the dead rows are compacted out host-side
    (same ops as ``take_snapshot``, hence bitwise the same snapshot).
    ``attrs`` is the store's f64 slab; only its f32 cast is materialized.
    ``q_vectors``/``q_scales`` are the checkpoint's pre-quantized slabs
    (``vec_dtype`` != "f32"); they ride along so the cold start skips
    re-quantization, and are compacted by the same live-row gather.
    """
    n_all = vectors.shape[0]
    deleted = np.asarray(deleted, dtype=np.int64)
    if deleted.size == 0:
        attrs32 = np.asarray(attrs, dtype=np.float32)
        order = np.argsort(attrs32, kind="stable")
        sorted_attrs = attrs32[order]
        uniq_mask = np.ones(n_all, dtype=bool)
        uniq_mask[1:] = sorted_attrs[1:] != sorted_attrs[:-1]
        return Snapshot(
            vectors=vectors,
            sq_norms=sq_norms,
            attrs=attrs32,
            neighbors=neighbors,
            uvals=sorted_attrs[uniq_mask].astype(np.float32),
            uval_rep=order[uniq_mask].astype(np.int32),
            ids_map=np.arange(n_all, dtype=np.int64),
            m=m,
            o=o,
            metric=metric,
            stamp=stamp,
            q_vectors=q_vectors,
            q_scales=q_scales,
            vec_dtype=vec_dtype,
        )
    dead = set(deleted.tolist())
    live = np.asarray(
        [i for i in range(n_all) if i not in dead], dtype=np.int64
    )
    if len(live) == 0:
        raise ValueError("cannot snapshot fully-deleted slabs")
    n = len(live)
    remap = np.full(n_all, -1, dtype=np.int32)
    remap[live] = np.arange(n, dtype=np.int32)
    vec_c = np.asarray(vectors)[live].astype(np.float32)
    nrm_c = np.asarray(sq_norms)[live].astype(np.float32)
    att_c = np.asarray(attrs)[live].astype(np.float32)
    rows = np.asarray(neighbors)[:, live]
    mapped = np.where(rows >= 0, remap[np.maximum(rows, 0)], -1)
    order = np.argsort(mapped < 0, axis=2, kind="stable")
    nbr_c = np.take_along_axis(mapped, order, axis=2).astype(np.int32)
    order = np.argsort(att_c, kind="stable")
    sorted_attrs = att_c[order]
    uniq_mask = np.ones(n, dtype=bool)
    uniq_mask[1:] = sorted_attrs[1:] != sorted_attrs[:-1]
    return Snapshot(
        vectors=vec_c,
        sq_norms=nrm_c,
        attrs=att_c,
        neighbors=nbr_c,
        uvals=sorted_attrs[uniq_mask].astype(np.float32),
        uval_rep=order[uniq_mask].astype(np.int32),
        ids_map=live,
        m=m,
        o=o,
        metric=metric,
        stamp=stamp,
        q_vectors=None if q_vectors is None else np.asarray(q_vectors)[live],
        q_scales=None if q_scales is None else np.asarray(q_scales)[live],
        vec_dtype=vec_dtype,
    )


class NeighborSlab:
    """Persistent top-down host neighbor slab for the batched build loop.

    Layout matches what ``search_candidates_batch`` consumes: row ``v``'s
    columns are ``[layer top | top-1 | ... | 0]`` blocks of ``m`` slots
    each, so a search over layers ``[l_min, top]`` takes the ``[:n, :F]``
    prefix view.  Allocated once at graph-arena capacity (rows beyond ``n``
    are -1 in the graph arena and stay -1 here, so appends cost nothing);
    each micro-batch scatters only the rows it committed.  A full rebuild
    happens only when the graph reallocated (capacity or top growth) or a
    mutation bypassed the delta protocol (``LayeredGraph.version`` moved
    without ``apply_deltas`` seeing it) — both amortised, never per batch.
    """

    __slots__ = ("arr", "top", "cap", "m", "version", "stats")

    def __init__(self):
        self.arr: np.ndarray | None = None
        self.top = -1
        self.cap = 0
        self.m = 0
        self.version = -1
        self.stats = {"full_builds": 0, "rows_scattered": 0}

    def ensure(self, graph) -> np.ndarray:
        """Return the slab, rebuilding in full only when stale."""
        if (
            self.arr is None
            or self.top != graph.top
            or self.cap != graph.capacity
            or self.version != graph.version
        ):
            self.top = graph.top
            self.cap = graph.capacity
            self.m = graph.m
            self.arr = np.concatenate(
                [graph.layers[l] for l in range(graph.top, -1, -1)], axis=1
            )
            self.version = graph.version
            self.stats["full_builds"] += 1
        return self.arr

    def apply_deltas(self, graph, dirty: dict[int, np.ndarray]) -> None:
        """Scatter the changed (layer, vertex) rows; O(rows), not O(n)."""
        assert self.arr is not None and self.top == graph.top
        for l, rows in dirty.items():
            if rows.size == 0:
                continue
            c0 = (self.top - l) * self.m
            self.arr[rows, c0 : c0 + self.m] = graph.layers[l][rows]
            self.stats["rows_scattered"] += int(rows.size)
        self.version = graph.version

