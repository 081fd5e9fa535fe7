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

  * ``DeviceBuildArena`` — the device-resident twin for
    ``insert_batch(backend="device"|"ops")``: the vectors, norms, attrs and
    the ``[L, rows, m]`` adjacency live on the card at pow2 row capacity,
    uploaded in full only when stale and otherwise updated in place with
    the batch's appended rows and the commit's changed neighbor rows
    (``repro_torch.kernels.ops.arena_scatter*``).

  * ``ShardedBuildArena`` — the ``DeviceBuildArena`` of
    ``insert_batch(backend="sharded")``: every rank of a build mesh holds
    its own copy, and its searches split the micro-batch over the ranks
    (``repro_torch.core.distributed.sharded_build_search``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np

from ..monitoring import register_counters, span


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
    fast = _fast_refresh_ok(index, prev)
    with span("repro_torch.snapshot.take",
              mode="incremental" if fast else "full"):
        if fast:
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



class DeviceBuildArena:
    """Device-resident frozen snapshot + delta arena for batched builds.

    Mirrors the host arenas into torch tensors once (at pow2 row capacity),
    then absorbs each micro-batch with bounded-size in-place scatters: the
    batch's new vectors/attrs/norms land in the pre-sized tail, and the
    commit's changed neighbor rows are scattered into the ``[L, rows, m]``
    adjacency — no per-batch ``np.stack`` and no per-batch O(n) host->device
    upload.

    ``vec_dtype`` != "f32" stores the vector slab quantized on device (int8
    with a parallel f32 ``q_scales`` arena, or bf16): full uploads quantize
    host-side, appends quantize just the new rows, and the fused gather
    kernel dequantizes in registers.  Per-row quantization keeps
    incremental scatters bitwise identical to a full re-quantization.

    ``device=None`` is the CUDA card.
    """

    __slots__ = (
        "vectors", "sq_norms", "attrs", "neighbors", "cap", "dim", "m", "o",
        "metric", "num_layers", "version", "n_synced", "stats", "_dummy_u",
        "_dummy_r", "vec_dtype", "q_scales", "device", "__weakref__",
    )
    STATS = ("full_uploads", "rows_scattered", "rows_appended", "searches")

    def __init__(self, vec_dtype: str = "f32", device=None):
        from .. import resolve_device
        from .store import VEC_DTYPES

        if vec_dtype not in VEC_DTYPES:
            raise ValueError(
                f"vec_dtype must be one of {VEC_DTYPES}, got {vec_dtype!r}"
            )
        self.device = resolve_device(device)
        self.vec_dtype = vec_dtype
        self.q_scales = None  # f32[rows] per-row dequant scales (int8 only)
        self.vectors = None
        self.sq_norms = None
        self.attrs = None
        self.neighbors = None
        self.cap = 0
        self.dim = 0
        self.m = 0
        self.o = 0
        self.metric = "l2"
        self.num_layers = 0
        self.version = -1
        self.n_synced = 0
        self.stats = dict.fromkeys(self.STATS, 0)
        self._dummy_u = None
        self._dummy_r = None
        _ARENAS.add(self)

    def nbytes(self) -> int:
        """Device bytes the arena holds (vectors, scales, norms, attrs,
        adjacency)."""
        ts = (self.vectors, self.q_scales, self.sq_norms, self.attrs,
              self.neighbors)
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    # ------------------------------------------------------------------ sync
    def ensure(self, index) -> None:
        """Bring the arena up to the index's pre-batch state: full upload
        only when stale (capacity/top growth or an untracked mutation),
        otherwise scatter just the rows appended since the last sync."""
        import torch

        from ..kernels.ops import arena_scatter
        from .device_search import _slab_tensor
        from .store import quantize_rows

        graph, store = index.graph, index.store
        n = store.n
        dev = self.device
        if (
            self.neighbors is None
            or self.num_layers != graph.num_layers
            or self.cap != graph.capacity
            or self.version != graph.version
        ):
            self.cap = graph.capacity
            self.dim = store.dim
            self.m = graph.m
            self.o = index.params.o
            self.metric = index.params.metric
            self.num_layers = graph.num_layers
            # allocate at pow2 row capacity: pad rows carry -1 neighbors
            # and +inf attrs, so they are unreachable in phase-1 searches
            rows = _pow2ceil(max(self.cap, 1))
            vec = np.zeros((rows, self.dim), np.float32)
            vec[:n] = store.vectors[:n]
            nrm = np.zeros(rows, np.float32)
            nrm[:n] = store.sq_norms[:n]
            att = np.full(rows, np.inf, np.float32)
            att[:n] = store.attrs[:n]
            nb = np.full((graph.num_layers, rows, graph.m), -1, np.int32)
            nb[:, : self.cap] = np.stack(
                [lay for lay in graph.layers], axis=0
            )
            # quantized modes upload the slab in storage dtype (pad rows
            # are all-zero and quantize to 0)
            slab, scales = quantize_rows(vec, self.vec_dtype)
            self.vectors = _slab_tensor(slab, dev)
            self.q_scales = (None if scales is None
                             else torch.from_numpy(scales).to(dev))
            self.sq_norms = torch.from_numpy(nrm).to(dev)
            self.attrs = torch.from_numpy(att).to(dev)
            self.neighbors = torch.from_numpy(nb).to(dev)
            self._dummy_u = torch.zeros(1, dtype=torch.float32, device=dev)
            self._dummy_r = torch.zeros(1, dtype=torch.int32, device=dev)
            self.version = graph.version
            self.n_synced = n
            self.stats["full_uploads"] += 1
            return
        if n > self.n_synced:  # append the new rows into the pre-sized tail
            ids = np.arange(self.n_synced, n, dtype=np.int64)
            slab, scales = quantize_rows(store.vectors[ids], self.vec_dtype)
            arena_scatter(self.vectors, ids, slab)
            if scales is not None:
                arena_scatter(self.q_scales, ids, scales)
            arena_scatter(self.sq_norms, ids, store.sq_norms[ids])
            arena_scatter(self.attrs, ids,
                          store.attrs[ids].astype(np.float32))
            self.stats["rows_appended"] += int(ids.size)
            self.n_synced = n

    def apply_deltas(self, index, dirty: dict[int, np.ndarray]) -> None:
        """Scatter the commit's changed (layer, vertex) neighbor rows."""
        from ..kernels.ops import arena_scatter_layers

        graph = index.graph
        ls, vs, rows = [], [], []
        for l, r in dirty.items():
            if r.size == 0:
                continue
            ls.append(np.full(r.size, l, dtype=np.int64))
            vs.append(r.astype(np.int64))
            rows.append(graph.layers[l][r])
        if ls:
            l_arr = np.concatenate(ls)
            arena_scatter_layers(self.neighbors, l_arr, np.concatenate(vs),
                                 np.concatenate(rows))
            self.stats["rows_scattered"] += int(l_arr.size)
        self.version = graph.version

    # ---------------------------------------------------------------- search
    def device_index(self):
        """View the arena tensors as a ``DeviceIndex`` for the hop loop.
        Construction searches take explicit entries/landing layers, so the
        unique-value fields are dummies."""
        from .device_search import DeviceIndex

        return DeviceIndex(
            vectors=self.vectors,
            sq_norms=self.sq_norms,
            attrs=self.attrs,
            neighbors=self.neighbors,
            uvals=self._dummy_u,
            uval_rep=self._dummy_r,
            scales=self.q_scales if self.q_scales is not None else self._dummy_u,
        )

    def search(
        self,
        targets: np.ndarray,
        ranges: np.ndarray,
        eps: np.ndarray,
        l_lo: int,
        l_hi: int,
        seed_ids: np.ndarray | None,
        seed_d: np.ndarray | None,
        width: int,
        seed_width: int,
        deleted: set[int] | None = None,
        backend: str = "auto",
        visited: str = "hash",
        visited_bits: int | None = None,
    ):
        """Run one per-layer candidate beam search of a micro-batch through
        the device hop pipeline.  Returns ``(res_i, res_d, dc, hops)`` in
        host numpy with deleted ids masked out (-1), mirroring
        ``search_candidates_batch``'s contract."""
        from .device_search import build_search

        self.stats["searches"] += 1
        return build_search(
            self.device_index(),
            targets,
            ranges,
            eps,
            l_lo,
            l_hi,
            seed_ids,
            seed_d,
            width=width,
            m=self.m,
            o=self.o,
            metric="l2" if self.metric == "l2" else "cosine",
            seed_width=seed_width,
            deleted=deleted,
            backend=backend,
            visited=visited,
            visited_bits=visited_bits,
        )


class ShardedBuildArena(DeviceBuildArena):
    """``DeviceBuildArena`` held by every rank of a build mesh (a
    ``repro_torch.parallel.BuildMesh``), whose searches split the
    micro-batch members over the ranks (``insert_batch(backend=
    "sharded")``).

    Lifecycle: a full upload (amortised: capacity/top growth or untracked
    mutations only) places every buffer on the rank's device through
    ``repro_torch.kernels.ops.replicate``; the per-batch delta scatters
    update it in place.  Every rank applies the same commits, so the
    ranks' copies hold the same bytes, as the JAX version's replicated
    buffers do.  Phase-1 searches dispatch through
    ``repro_torch.core.distributed.sharded_build_search``: each rank runs
    the device hop pipeline on its member slice, and the per-member
    candidate sets are all-gathered back to the host, bitwise those of
    the one-device build at any shard count, so the deterministic phase-2
    commit needs no shard awareness.  A search is the span
    ``repro_torch.build.sharded_search``, its all-gather
    ``repro_torch.build.gather`` (``repro_torch.monitoring``).
    """

    __slots__ = ("mesh",)

    def __init__(self, mesh, vec_dtype: str = "f32"):
        super().__init__(vec_dtype=vec_dtype, device=mesh.device)
        self.mesh = mesh

    @property
    def num_shards(self) -> int:
        return self.mesh.shards

    def ensure(self, index) -> None:
        uploads = self.stats["full_uploads"]
        super().ensure(index)
        if self.stats["full_uploads"] != uploads:
            from ..kernels.ops import replicate

            (self.vectors, self.sq_norms, self.attrs, self.neighbors,
             self._dummy_u, self._dummy_r, self.q_scales) = replicate(
                (self.vectors, self.sq_norms, self.attrs, self.neighbors,
                 self._dummy_u, self._dummy_r, self.q_scales),
                self.mesh,
            )

    def search(
        self,
        targets: np.ndarray,
        ranges: np.ndarray,
        eps: np.ndarray,
        l_lo: int,
        l_hi: int,
        seed_ids: np.ndarray | None,
        seed_d: np.ndarray | None,
        width: int,
        seed_width: int,
        deleted: set[int] | None = None,
        backend: str = "auto",
        visited: str = "hash",
        visited_bits: int | None = None,
    ):
        from .distributed import sharded_build_search

        self.stats["searches"] += 1
        with span("repro_torch.build.sharded_search", rows=len(targets)):
            return sharded_build_search(
                self.mesh,
                self.device_index(),
                targets,
                ranges,
                eps,
                l_lo,
                l_hi,
                seed_ids,
                seed_d,
                width=width,
                m=self.m,
                o=self.o,
                metric="l2" if self.metric == "l2" else "cosine",
                seed_width=seed_width,
                deleted=deleted,
                backend=backend,
                visited=visited,
                visited_bits=visited_bits,
                axis=self.mesh.axis,
            )


_ARENAS = weakref.WeakSet()  # live build arenas, for ``monitoring.counters()``


def _arena_counters() -> dict:
    out = dict.fromkeys(DeviceBuildArena.STATS, 0)
    for arena in list(_ARENAS):
        for k in out:
            out[k] += arena.stats[k]
    return out


register_counters("snapshot.DeviceBuildArena", _arena_counters)
