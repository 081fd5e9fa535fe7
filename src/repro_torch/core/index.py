"""WoW index — public API (Algorithms 1 and 3).

Fully incremental from an empty index, no presorting, no partial indexing
(Challenge 1).  Duplicate attribute values are native (§3.7): the WBT stores
unique values only; duplicates share a rank and only their vectors enter the
window graphs.  Deletion is mark-based (§3.7); selectivity estimates for the
landing layer subtract *dead* values (unique values whose vectors are all
deleted) so Algorithm 3 lands where the live data actually is.

Usage::

    idx = WoWIndex(dim=128, m=16, ef_construction=128, o=4)
    for v, a in zip(vectors, attrs):
        idx.insert(v, a)
    ids, dists, stats = idx.search(q, (lo, hi), k=10, ef=64)

Batched construction
--------------------

``insert_batch`` runs Algorithm 1 over a micro-batch: the batch's attribute
values are registered into the WBT up front (so windows are computed against
the post-batch value set), the per-layer candidate beam searches of ALL
pending inserts execute as one lock-step batched evaluation
(``search_candidates_batch`` — per hop, every member's admitted neighbors
are distance-evaluated in a single BLAS/kernel call instead of B separate
Python ``heapq`` loops), and forward/back edges are committed in a
conflict-aware sequential order: member ``b`` additionally sees every
earlier-committed batch member inside its layer window as a candidate (with
exact [B, B] cross distances), so the committed graph is equivalent to a
sequential insertion in batch order where each search ran against the
batch-start graph.  Window invariants (Def. 4) hold per layer against the
final WBT state; DC accounting is preserved per insert in ``BuildStats``.
The sequential ``insert`` path is unchanged and remains the parity oracle
(see ``tests/test_batch_build.py``)::

    idx = WoWIndex(dim=128, m=16, ef_construction=128, o=4)
    idx.insert_batch(vectors, attrs, batch_size=128)  # ~3x faster build
"""
from __future__ import annotations

import bisect
import logging
import math
from dataclasses import dataclass, field

import numpy as np

from .graph import LayeredGraph
from .search import (
    VisitedArena2D,
    _Visited,
    rng_prune,
    rng_prune_ids,
    rng_prune_rows,
    search_candidates,
    search_candidates_batch,
)
from .snapshot import DeviceBuildArena, NeighborSlab
from .store import VEC_DTYPES, BuildStats, SearchStats, VectorStore

#: registered ``insert_batch`` phase-1 engines; an unknown ``backend=``
#: raises ``ValueError`` naming these (never a silent numpy fall-through).
#: The reference's "sharded" engine comes with the sharded build (ROADMAP
#: A8).
INSERT_BACKENDS = ("numpy", "ops", "device")

_log = logging.getLogger("repro_torch.core.index")


@dataclass
class WoWParams:
    m: int = 16  # maximum outdegree
    ef_construction: int = 128  # construction beam width (omega_c)
    o: int = 4  # window boosting base (>= 2)
    metric: str = "l2"
    seed: int = 0

    def __post_init__(self) -> None:
        if self.o < 2:
            raise ValueError("window boosting base o must be >= 2")
        if self.m < 2:
            raise ValueError("m must be >= 2")


class WoWIndex:
    def __init__(
        self,
        dim: int,
        m: int = 16,
        ef_construction: int = 128,
        o: int = 4,
        metric: str = "l2",
        seed: int = 0,
        compact_threshold: float | None = None,
        vec_dtype: str = "f32",
        device=None,
    ):
        self.params = WoWParams(m, ef_construction, o, metric, seed)
        # torch device of the build arena of the "ops"/"device" insert
        # backends (None = the CUDA card, resolved when the arena is made;
        # the numpy backend never touches it)
        self.device = device
        if vec_dtype not in VEC_DTYPES:
            raise ValueError(
                f"vec_dtype must be one of {VEC_DTYPES}, got {vec_dtype!r}"
            )
        # device-slab storage mode for build arenas + serving snapshots:
        # "f32" (exact; the parity oracle), "bf16", or "int8" (per-row f32
        # scales).  Host vectors stay f32 — quantization happens at the
        # device upload boundary and dequant is fused inside the gather
        # kernel, so the quantized rows never round-trip through host f32.
        self.vec_dtype = vec_dtype
        self.store = VectorStore(dim, metric=metric)
        self.graph = LayeredGraph(m)
        from .wbt import WBT

        self.wbt = WBT()
        self.value_map: dict[float, list[int]] = {}
        self.deleted: set[int] = set()
        # delete-aware selectivity: live vector count per unique value and
        # the sorted list of *dead* values (all duplicates deleted) — the WBT
        # never removes values, so n' must subtract these (Alg. 3).
        self._live_counts: dict[float, int] = {}
        self._dead_vals: list[float] = []
        # monotone mutation stamp: bumped by insert/insert_batch/delete/
        # undelete, so snapshot caches (RagPipeline) can detect ANY change —
        # (n, len(deleted)) alone misses undelete+delete pairs.
        self.mutations = 0
        self.build_stats = BuildStats()
        self._visited = _Visited()
        self._rng = np.random.default_rng(seed)
        # persistent batched-build state (allocated once, delta-maintained —
        # no Theta(n) work inside the micro-batch loop):
        #   _slab      host top-down neighbor slab (numpy/ops backends)
        #   _arena     device-resident frozen snapshot + delta arena
        #   _visited2d generation-stamped [B, n] visited arena (host search)
        self._slab = NeighborSlab()
        self._arena: DeviceBuildArena | None = None
        self._visited2d = VisitedArena2D()
        # dirty-row tracking for incremental snapshot refresh
        # (take_snapshot(prev=...)): "all" forces a full rebuild; reset by
        # every take_snapshot, fed by the batched commit.
        self._snap_tracker: dict = {"stamp": -1, "all": True, "dirty": {}}
        # second dirty-row tracker for incremental checkpointing
        # (repro_torch.persist.checkpoint): same feed, independent reset —
        # the snapshot consumer resetting its tracker must not blind the
        # checkpoint consumer.  Unlike the snapshot tracker, deletes do NOT
        # invalidate it (checkpoints serialize tombstones separately; the
        # graph arrays are untouched by a mark-based delete).
        self._ckpt_tracker: dict = {"stamp": -1, "all": True, "dirty": {}}
        # durable lifecycle (repro_torch.persist): attached write-ahead
        # log, replay guard, and the LSN of the last logged-and-applied
        # record
        self._wal = None
        self._wal_replaying = False
        self._applied_lsn = 0
        # replication fencing epoch/term, stamped into WAL segment headers
        # and checkpoint manifests (0 until replication is ported: ROADMAP
        # A6b; carried so either package's logs and checkpoints round-trip)
        self._epoch = 0
        # rows the last recovery re-applied from the log, counted once by
        # the first serve engine over this index (stats.ingest_replayed)
        self._replayed_rows = 0
        # background compaction cadence policy: auto-trigger compact_rows()
        # when len(deleted)/n crosses the threshold, checked at
        # insert_batch and checkpoint boundaries.  The latch
        # (_compact_dead_done = len(deleted) at the last compaction) stops
        # re-triggering until NEW tombstones accumulate — compact_rows
        # never shrinks ``deleted``, so the raw fraction alone would
        # re-fire on every batch.
        self.compact_threshold = compact_threshold
        self._compact_dead_done = 0
        self.compactions = 0  # auto-triggered compaction count

    # ------------------------------------------------------------ properties
    def __len__(self) -> int:
        return self.store.n - len(self.deleted)

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def top(self) -> int:
        return self.graph.top

    @property
    def num_unique(self) -> int:
        return self.wbt.n

    # ---------------------------------------------------------------- insert
    def insert(self, vec: np.ndarray, attr: float) -> int:
        """Algorithm 1: top-down insertion. Returns the new vertex id."""
        p = self.params
        m, o, omega_c = p.m, p.o, p.ef_construction
        # canonicalize to an exactly-f32-representable order key BEFORE the
        # WAL append, so a replayed record re-derives the identical value
        # and f32 consumers (device slabs, checkpoint dead_vals) agree
        # bitwise with the host (see VectorStore.append)
        attr = float(np.float32(attr))
        vec = np.asarray(vec, dtype=np.float32)
        self._validate_ingest(vec.reshape(1, -1),
                              np.asarray([attr], dtype=np.float64))
        if self._wal is not None and not self._wal_replaying:
            lsn = self._wal.log_seq_insert(vec.reshape(-1), attr)
        else:
            lsn = None
        is_new_value = not self.wbt.contains(attr)
        u_after = self.wbt.n + (1 if is_new_value else 0)

        # Lines 2-4: raise the top layer when its window cannot cover |A|_u.
        while u_after > 2 * (o ** self.graph.top):
            self.graph.add_layer(clone_from=self.graph.top)

        vid = self.store.append(vec, attr)
        self.graph.ensure_capacity(self.store.n)
        v = self.store.vectors[vid]
        top = self.graph.top

        # Lines 5-17: per-layer candidate acquisition + neighbor selection.
        neighbors_per_layer: list[list[tuple[float, int]]] = [[] for _ in range(top + 1)]
        u_prev: list[tuple[float, int]] = []  # U^{l+1}; U^{top+1} = empty
        if self.store.n > 1:
            attrs = self.store.attrs_list
            for l in range(top, -1, -1):
                half = o**l
                w_lo, w_hi = self.wbt.window(attr, half)
                # in-window candidates carried from the layer above (Thm 3.1)
                u_in = [(d, j) for (d, j) in u_prev if w_lo <= attrs[j] <= w_hi]
                if len(u_in) > m:
                    u_l = u_in
                    self.build_stats.searches_skipped += 1
                else:
                    ep = self._sample_entry(w_lo, w_hi, exclude=vid)
                    if ep is None:
                        u_l = u_in
                    else:
                        stats = SearchStats()
                        found = search_candidates(
                            self.store,
                            self.graph,
                            self._visited,
                            ep,
                            v,
                            (w_lo, w_hi),
                            l_min=l,
                            l_max=top,
                            width=omega_c,
                            stats=stats,
                            exclude=vid,
                            deleted=self.deleted or None,
                        )
                        self.build_stats.dc += stats.dc
                        self.build_stats.searches += 1
                        merged = {j: d for d, j in u_in}
                        for d, j in found:
                            merged.setdefault(j, d)
                        u_l = [(d, j) for j, d in merged.items()]
                # Line 11: select m/2 diversified neighbors, reserve slots.
                sel = rng_prune(self.store, v, u_l, max(1, m // 2))
                neighbors_per_layer[l] = sel
                # Lines 12-17: back-edges with two-stage pruning.
                for d_ab, b in sel:
                    if self.graph.append_neighbor(l, b, vid):
                        continue
                    self._two_stage_prune(l, b, vid, d_ab)
                u_prev = u_l

        # Line 18: commit the attribute and the forward edges.
        if is_new_value:
            self.wbt.insert(attr)
            self.value_map[attr] = [vid]
        else:
            self.value_map[attr].append(vid)
        self._note_live_insert(attr)
        self.mutations += 1
        self._snap_tracker["all"] = True  # row-level dirt untracked here
        self._ckpt_tracker["all"] = True
        for l in range(top + 1):
            sel = neighbors_per_layer[l]
            if sel:
                self.graph.set_neighbors(
                    l, vid, np.asarray([j for _, j in sel], dtype=np.int32)
                )
        if lsn is not None:
            self._applied_lsn = lsn
        return vid

    def insert_batch(
        self,
        vectors: np.ndarray,
        attrs: np.ndarray,
        batch_size: int = 128,
        backend: str = "numpy",
        device_width: int | None = None,
    ) -> np.ndarray:
        """Batched Algorithm 1 (module docstring, "Batched construction").

        ``vectors`` [N, d] and ``attrs`` [N] are split into micro-batches of
        ``batch_size``; each micro-batch's per-layer candidate searches run
        as one lock-step batched evaluation and its edges are committed in a
        sequential-equivalent order.  ``backend`` selects the phase-1
        candidate-search engine; the registered set is ``INSERT_BACKENDS``
        and anything else raises:

          * ``"numpy"`` (default) — host BLAS lock-step search
            (``search_candidates_batch``) over the persistent neighbor slab;
          * ``"ops"`` — the host search with hop distance evaluation routed
            through ``repro_torch.kernels.ops.gather_norm_dot`` (the serving
            path's fused gather kernel dispatch) against the device vector
            arena;
          * ``"device"`` — the whole per-layer beam search runs through the
            ``device_search`` hop pipeline against the device-resident
            frozen snapshot + delta arena (``DeviceBuildArena``): carry-
            seeded beams, hashed O(budget) visited filter, fused gather
            kernel — the device-resident build.

        The device arena lives on ``self.device`` (the constructor's
        ``device=``; None = the CUDA card).  The reference's ``"sharded"``
        engine comes with the sharded build (ROADMAP A8); a logged
        ``"sharded"`` record replays on ``"device"``
        (``persist.wal.apply_record``).

        ``device_width`` narrows the device search's beam below
        ``ef_construction`` (default: equal, matching the host search).

        With a write-ahead log attached (``repro_torch.persist.
        open_durable``) every micro-batch is logged and fsynced before it
        is applied: a crash mid-apply replays the record, a crash before
        the append loses only that unacknowledged micro-batch.

        All backends commit identically (phase 2 is the deterministic host
        reduction) and maintain their arenas incrementally: the neighbor
        slab, device arena and visited arena are allocated once and updated
        with per-batch deltas / generation stamps — no Theta(n) work inside
        the micro-batch loop.

        Returns the new vertex ids.
        """
        if backend not in INSERT_BACKENDS:
            hint = (" (the sharded build is not ported yet: ROADMAP A8)"
                    if backend == "sharded" else "")
            raise ValueError(
                f"unknown insert_batch backend {backend!r}; registered "
                f"backends: {', '.join(INSERT_BACKENDS)}{hint}"
            )
        if device_width is not None and backend != "device":
            raise ValueError(
                "device_width= applies only to backend='device' "
                f"(got backend={backend!r})"
            )
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors.reshape(1, -1)
        # f32-canonical attrs BEFORE validation and the WAL append (see
        # ``insert``): replay re-derives identical order keys, and a value
        # too large for f32 becomes inf here and is rejected below
        attrs = (
            np.asarray(attrs, dtype=np.float64)
            .reshape(-1)
            .astype(np.float32)
            .astype(np.float64)
        )
        if len(vectors) != len(attrs):
            raise ValueError(f"{len(vectors)} vectors vs {len(attrs)} attrs")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        # reject the whole batch BEFORE any WBT/graph/WAL mutation: a bad
        # row must never leave a half-committed micro-batch behind
        self._validate_ingest(vectors, attrs)
        # insert_batch is a compaction-cadence boundary (checked up front:
        # the tombstone fraction only decreases within this call, so the
        # per-call check replays deterministically record by record)
        self._maybe_auto_compact()
        log_wal = self._wal is not None and not self._wal_replaying
        out = []
        for s in range(0, len(attrs), batch_size):
            vs = vectors[s : s + batch_size]
            as_ = attrs[s : s + batch_size]
            if log_wal:
                # log -> fsync -> apply
                lsn = self._wal.log_insert(vs, as_, backend=backend,
                                           device_width=device_width,
                                           shards=None)
            out.append(
                self._insert_micro_batch(vs, as_, backend, device_width)
            )
            if log_wal:
                self._applied_lsn = lsn
        return (np.concatenate(out) if out else np.empty(0, dtype=np.int64))

    def _validate_ingest(self, vectors: np.ndarray, attrs: np.ndarray) -> None:
        """Ingest input validation (raises ``ValueError`` before any state
        is touched): attribute values must be finite (NaN/inf would poison
        the WBT's total order and every window bound), vectors must match
        the store dimension and be finite (a NaN row turns every distance
        involving it into NaN, silently corrupting neighbor selection)."""
        if vectors.ndim != 2 or vectors.shape[1] != self.store.dim:
            raise ValueError(
                f"vectors have dimension {vectors.shape[-1] if vectors.ndim else 0}, "
                f"index expects {self.store.dim}"
            )
        if attrs.size and not np.isfinite(attrs).all():
            bad = np.nonzero(~np.isfinite(attrs))[0]
            raise ValueError(
                f"non-finite attribute value(s) at row(s) "
                f"{bad[:8].tolist()}{'...' if bad.size > 8 else ''}"
            )
        if vectors.size and not np.isfinite(vectors).all():
            bad = np.nonzero(~np.isfinite(vectors).all(axis=1))[0]
            raise ValueError(
                f"non-finite vector component(s) at row(s) "
                f"{bad[:8].tolist()}{'...' if bad.size > 8 else ''}"
            )

    def _maybe_auto_compact(self) -> None:
        """Background compaction cadence policy: run ``compact_rows`` when
        the tombstone fraction reaches ``compact_threshold`` and new
        tombstones accumulated since the last pass.  Called at
        ``insert_batch`` and checkpoint boundaries; a WAL replay skips it —
        every triggered pass was itself logged as a COMPACT record, so
        replay reproduces compactions exactly where they happened."""
        thr = self.compact_threshold
        if thr is None or self._wal_replaying or self.store.n == 0:
            return
        nd = len(self.deleted)
        if nd <= self._compact_dead_done or nd / self.store.n < thr:
            return
        rebuilt = self.compact_rows()
        self.compactions += 1
        _log.info(
            "auto compaction #%d: tombstone fraction %.3f >= %.3f, "
            "%d rows rebuilt (%d tombstones, n=%d)",
            self.compactions, nd / self.store.n, thr, rebuilt, nd,
            self.store.n,
        )

    def _insert_micro_batch(
        self,
        vecs: np.ndarray,
        attrs_b: np.ndarray,
        backend: str,
        device_width: int | None = None,
    ) -> np.ndarray:
        p = self.params
        m, o, omega_c = p.m, p.o, p.ef_construction
        B = len(attrs_b)
        if B == 0:
            return np.empty(0, dtype=np.int64)
        # arena resolution, BEFORE liveness is judged: the ops/device
        # backends own a ``DeviceBuildArena`` of the index's storage mode;
        # a storage-mode change swaps it, and its next ``ensure`` does one
        # amortised full upload.
        if backend in ("ops", "device") and (
            self._arena is None or self._arena.vec_dtype != self.vec_dtype
        ):
            self._arena = DeviceBuildArena(vec_dtype=self.vec_dtype,
                                           device=self.device)
        # mirror liveness, judged BEFORE this batch mutates anything: a
        # mirror that was in sync at batch start stays maintainable by this
        # batch's deltas alone (even if the other backend drives phase 1),
        # so backend switches never force full rebuilds.
        g = self.graph
        slab_pre_ok = self._slab.arr is not None and self._slab.version == g.version
        arena_pre_ok = (
            self._arena is not None
            and self._arena.neighbors is not None
            and self._arena.version == g.version
        )
        # ---- Lines 2-4 + 18 (attribute side), hoisted batch-wide: register
        # every value first so windows see the post-batch value set.
        vals = [float(a) for a in attrs_b]
        new_vals = {v for v in vals if not self.wbt.contains(v)}
        u_after = self.wbt.n + len(new_vals)
        while u_after > 2 * (o**self.graph.top):
            self.graph.add_layer(clone_from=self.graph.top)
        vids = self.store.append_batch(vecs, attrs_b)
        self.graph.ensure_capacity(self.store.n)
        for v in sorted(new_vals):
            self.wbt.insert(v)
        for vid, val in zip(vids.tolist(), vals):
            self.value_map.setdefault(val, []).append(vid)
            self._note_live_insert(val)
        self.mutations += B
        top = self.graph.top
        batch_set = set(vids.tolist())
        targets = self.store.vectors[vids]  # prepared (cosine-normalised) rows
        attrs_np = self.store.attrs

        # Per-member per-layer windows w.r.t. the post-batch value set — the
        # rank arithmetic of Alg. 4 vectorised over the sorted unique values
        # (``value_map`` keys mirror the WBT's content exactly; every batch
        # value is already registered, so ``above_start = rank + 1``).
        uvals = np.fromiter(
            self.value_map.keys(), dtype=np.float64, count=len(self.value_map)
        )
        uvals.sort()
        u = len(uvals)
        vals_arr = np.asarray(vals, dtype=np.float64)
        r = np.searchsorted(uvals, vals_arr, side="left")
        wlo = np.empty((B, top + 1))
        whi = np.empty((B, top + 1))
        for l in range(top + 1):
            half = o**l
            lo_idx = np.maximum(0, r - half)
            hi_idx = np.maximum(np.minimum(u - 1, r + half), lo_idx)
            wlo[:, l] = np.minimum(uvals[lo_idx], vals_arr)
            whi[:, l] = np.maximum(uvals[hi_idx], vals_arr)

        # ---- Phase 1 (lines 5-10): batched per-layer candidate acquisition
        # against the batch-start graph (frozen during this phase).  The
        # carry U^{l+1} lives in padded [B, C] arrays: the window filter,
        # the Thm-3.1 skip test and the carry/search merge (an id-sorted
        # dedupe that keeps the carry's copy) are all row-parallel.
        C = 2 * omega_c + 2
        u_ids = np.full((B, C), -1, dtype=np.int64)
        u_d = np.full((B, C), np.inf, dtype=np.float64)
        u_lay_ids: list[np.ndarray] = [None] * (top + 1)  # type: ignore[list-item]
        u_lay_d: list[np.ndarray] = [None] * (top + 1)  # type: ignore[list-item]
        abb = np.arange(B)[:, None]
        slab_full = None
        arena = None
        ops_table = None
        ops_scales = None
        if self.store.n > B:  # the pre-batch graph is non-empty
            # the graph is frozen during phase 1; the persistent arenas are
            # brought up to date with deltas only (allocation/rebuild is
            # amortised over capacity growth, never per batch)
            if backend in ("ops", "device"):
                arena = self._arena
                arena.ensure(self)
                if backend == "ops":
                    ops_table = arena.vectors  # device-resident [rows, d]
                    ops_scales = arena.q_scales  # f32[rows] (int8) / None
            if backend != "device":
                slab_full = self._slab.ensure(self.graph)
            uw = 0  # used carry width: every [B, C] pass runs on [:, :uw]
            for l in range(top, -1, -1):
                # window-filter the carry (Alg. 1 line 6, all rows at once)
                if uw:
                    uv = u_ids[:, :uw]
                    am = attrs_np[np.maximum(uv, 0)]
                    inw = (
                        (uv >= 0)
                        & (am >= wlo[:, l, None])
                        & (am <= whi[:, l, None])
                    )
                    u_ids[:, :uw] = np.where(inw, uv, -1)
                    u_d[:, :uw] = np.where(inw, u_d[:, :uw], np.inf)
                    skip = inw.sum(axis=1) > m  # Thm 3.1: carry suffices
                else:
                    skip = np.zeros(B, dtype=bool)
                self.build_stats.searches_skipped += int(skip.sum())
                # vectorised Alg. 1 line 7: sample entry *ranks* for every
                # member at once (4 tries each before the linear fallback)
                lo_r = np.searchsorted(uvals, wlo[:, l], side="left")
                hi_r = np.searchsorted(uvals, whi[:, l], side="right") - 1
                span = np.maximum(hi_r - lo_r + 1, 1)
                ks = lo_r[None, :] + (
                    self._rng.random((4, B)) * span[None, :]
                ).astype(np.int64)
                choice = self._rng.random((4, B))
                # warm-start: members with a carry seed their beam with the
                # whole in-window carried candidate set (ids + distances
                # already known — no DC, no random-walk approach hops);
                # members with an empty carry fall back to Alg. 1 line 7's
                # sampled window entry.
                if uw:
                    has_carry = (u_ids[:, :uw] >= 0).any(axis=1)
                else:
                    has_carry = np.zeros(B, dtype=bool)
                need: list[int] = []
                eps: list[int] = []
                for b in np.nonzero(~skip)[0].tolist():
                    if has_carry[b]:
                        need.append(b)
                        eps.append(0)  # unused: the seeds replace the entry
                        continue
                    ep = self._pick_entry(
                        uvals, ks[:, b], choice[:, b], lo_r[b], hi_r[b],
                        batch_set,
                    )
                    if ep is not None:
                        need.append(b)
                        eps.append(ep)
                if need:
                    seeds_i = u_ids[need, :uw] if uw else None
                    seeds_d = u_d[need, :uw] if uw else None
                    if backend == "device":
                        # device-resident phase 1: the hop pipeline over
                        # the frozen snapshot + delta arena, beams seeded
                        # with the Thm-3.1 carry
                        res_i, res_d, dcs, _ = arena.search(
                            targets[need],
                            np.stack([wlo[need, l], whi[need, l]], axis=1),
                            np.asarray(eps, dtype=np.int64),
                            l,
                            top,
                            seeds_i,
                            seeds_d,
                            width=device_width or omega_c,
                            seed_width=C,
                            deleted=self.deleted or None,
                        )
                    else:
                        res_i, res_d, dcs, _, _ = search_candidates_batch(
                            self.store,
                            self.graph,
                            targets[need],
                            np.asarray(eps, dtype=np.int64),
                            np.stack([wlo[need, l], whi[need, l]], axis=1),
                            l_min=l,
                            l_max=top,
                            width=omega_c,
                            deleted=self.deleted or None,
                            backend=backend,
                            slab_cache=slab_full,
                            ops_table=ops_table,
                            ops_scales=ops_scales,
                            seed_ids=seeds_i,
                            seed_d=seeds_d,
                            visited_arena=self._visited2d,
                        )
                    self.build_stats.dc += int(dcs.sum())
                    self.build_stats.searches += len(need)
                    # merge found into the carry: id-sort dedupe keeping the
                    # carry's copy (stable sort; carry columns come first)
                    Bn = len(need)
                    abn = np.arange(Bn)[:, None]
                    cat_i = np.concatenate(
                        [u_ids[need][:, :uw], res_i.astype(np.int64)], axis=1
                    )
                    cat_d = np.concatenate(
                        [u_d[need][:, :uw], res_d.astype(np.float64)], axis=1
                    )
                    pad_key = np.where(cat_i >= 0, cat_i, np.int64(2**31))
                    order = np.argsort(pad_key, axis=1, kind="stable")
                    ks_s = pad_key[abn, order]
                    ci = cat_i[abn, order]
                    cd = cat_d[abn, order]
                    dup = np.zeros(ci.shape, dtype=bool)
                    dup[:, 1:] = ks_s[:, 1:] == ks_s[:, :-1]
                    drop = dup | (ks_s == 2**31)
                    ci = np.where(drop, -1, ci)
                    cd = np.where(drop, np.inf, cd)
                    # left-compact back into C columns; dropped entries sort
                    # last (inf), survivors by distance — so a rare carry
                    # overflow truncates the FARTHEST candidates, not the
                    # highest vertex ids
                    w2 = min(C, ci.shape[1])
                    ord2 = np.argsort(
                        np.where(drop, np.inf, cd), axis=1, kind="stable"
                    )[:, :w2]
                    u_ids[need, :w2] = ci[abn, ord2]
                    u_d[need, :w2] = cd[abn, ord2]
                    kept = int((ci.shape[1] - drop.sum(axis=1)).max())
                    uw = max(uw, min(C, kept))
                u_lay_ids[l] = u_ids[:, :uw].copy()
                u_lay_d[l] = u_d[:, :uw].copy()
        else:
            for l in range(top + 1):
                u_lay_ids[l] = u_ids
                u_lay_d[l] = u_d

        # ---- Phase 2 (lines 11-17): conflict-aware commit, equivalent to
        # sequential insertion in batch order.  Member b's candidates at
        # layer l are its searched set plus every earlier batch member
        # inside its window with exact [B, B] cross distances (batch members
        # are unreachable during phase 1, so there are no dupes).  Forward
        # selections depend only on these candidate sets — never on earlier
        # members' committed edges — so ALL (b, l) RNG prunes run as one
        # vectorised pass; back-edges then commit in batch order, with
        # contended vertices (full neighbor lists) resolved by one terminal
        # batched two-stage prune per (layer, vertex).
        if self.store.metric == "l2":
            sq = np.einsum("bd,bd->b", targets, targets)
            cross = sq[:, None] + sq[None, :] - 2.0 * (targets @ targets.T)
            np.maximum(cross, 0.0, out=cross)
        else:
            cross = 1.0 - targets @ targets.T
        cross = cross.astype(np.float64)
        m_fwd = max(1, m // 2)
        T = max(m + m // 2, 8)  # nearest-T pre-truncation (see rng_prune_rows)
        L1 = top + 1
        cand_ids = np.full((B * L1, T), -1, dtype=np.int64)
        cand_d = np.full((B * L1, T), np.inf, dtype=np.float64)
        tri = np.tri(B, B, -1, dtype=bool)  # member b sees only earlier b'
        vids_row = np.broadcast_to(vids[None, :], (B, B))
        for l in range(L1):
            cw = (
                tri
                & (vals_arr[None, :] >= wlo[:, l, None])
                & (vals_arr[None, :] <= whi[:, l, None])
            )
            self.build_stats.dc += int(cw.sum())
            cat_i = np.concatenate([u_lay_ids[l], vids_row], axis=1)
            cat_d = np.concatenate(
                [u_lay_d[l], np.where(cw, cross, np.inf)], axis=1
            )
            kc = cat_d.shape[1]
            if kc > T:
                part = np.argpartition(cat_d, T - 1, axis=1)[:, :T]
                sel_i = cat_i[abb, part]
                sel_d = cat_d[abb, part]
            else:
                sel_i = cat_i
                sel_d = cat_d
            sel_i = np.where(np.isfinite(sel_d), sel_i, -1)
            rows = np.arange(B) * L1 + l
            cand_ids[rows, : sel_i.shape[1]] = sel_i
            cand_d[rows, : sel_d.shape[1]] = sel_d
        sel_ids, sel_d, sel_mask = rng_prune_rows(
            self.store, cand_ids, cand_d, m_fwd
        )
        # ---- commit (batch order).  Forward lists: one scatter per layer.
        # Back-edges: grouped per layer by target — a stable sort keeps the
        # batch-order arrival sequence inside every (layer, target) run, so
        # slot assignment (old count + within-run position) reproduces the
        # sequential appends exactly; arrivals past slot m defer to the
        # terminal per-vertex prune.
        overflow: dict[tuple[int, int], list[tuple[int, float]]] = {}
        # changed (layer, vertex) rows of this commit — the delta the
        # persistent slab / device arena / snapshot tracker consume
        dirty: dict[int, list[np.ndarray]] = {}
        lay = self.graph.layers
        cnt = self.graph.counts
        sel3_i = sel_ids.reshape(B, L1, m_fwd)
        sel3_d = sel_d.reshape(B, L1, m_fwd)
        sel3_m = sel_mask.reshape(B, L1, m_fwd)
        for l in range(L1):
            fwd_i = sel3_i[:, l]  # [B, m_fwd] selection order, -1 padded
            fwd_m = sel3_m[:, l]
            deg = fwd_m.sum(axis=1).astype(np.int32)
            lay[l][vids, :m_fwd] = np.where(fwd_m, fwd_i, -1).astype(np.int32)
            lay[l][vids, m_fwd:] = -1
            cnt[l][vids] = deg
            dirty[l] = [vids]
            # (padding holes cannot occur: sel_mask is a selection-order
            # prefix — rng_prune_rows packs valid entries first)
            nb2, nc2 = np.nonzero(fwd_m)
            if nb2.size == 0:
                continue
            tgt = fwd_i[nb2, nc2]
            own = vids[nb2]
            dab = sel3_d[:, l][nb2, nc2]
            order = np.argsort(tgt, kind="stable")  # batch order within runs
            tgt_s, own_s, dab_s = tgt[order], own[order], dab[order]
            run_start = np.ones(len(tgt_s), dtype=bool)
            run_start[1:] = tgt_s[1:] != tgt_s[:-1]
            run_id = np.cumsum(run_start) - 1
            starts = np.nonzero(run_start)[0]
            pos = np.arange(len(tgt_s)) - starts[run_id]
            base = cnt[l][tgt_s]
            slot = base + pos
            ok = slot < self.graph.m
            lay[l][tgt_s[ok], slot[ok]] = own_s[ok].astype(np.int32)
            ends = np.append(starts[1:], len(tgt_s))
            new_deg = np.minimum(base[starts] + (ends - starts), self.graph.m)
            cnt[l][tgt_s[starts]] = new_deg.astype(np.int32)
            dirty[l].append(tgt_s[starts])  # unique back-edge targets
            nover = int((~ok).sum())
            if nover:
                self.build_stats.prunes += nover
                for t, o_, d_ in zip(
                    tgt_s[~ok].tolist(), own_s[~ok].tolist(), dab_s[~ok].tolist()
                ):
                    overflow.setdefault((l, t), []).append((o_, d_))
        if overflow:
            self._resolve_back_edge_overflow(overflow, uvals)
            for l, t in overflow.keys():
                dirty.setdefault(l, []).append(
                    np.asarray([t], dtype=np.int64)
                )
        # a mirror is delta-maintainable if phase 1 just (re)synced it, or
        # if it was in sync at batch start and the arenas did not regrow
        slab_live = slab_full is not None or (
            slab_pre_ok
            and self._slab.top == self.graph.top
            and self._slab.cap == self.graph.capacity
        )
        arena_live = arena is not None or (
            arena_pre_ok
            and self._arena.num_layers == self.graph.num_layers
            and self._arena.cap == self.graph.capacity
        )
        self._commit_deltas(
            dirty, self._arena if arena_live else None, slab_live
        )
        return vids

    def _commit_deltas(
        self,
        dirty: dict[int, list[np.ndarray]],
        arena: DeviceBuildArena | None,
        slab_live: bool,
    ) -> None:
        """Post-commit bookkeeping of one micro-batch: bump the graph's
        edge-version stamp (the batched commit scatters into the adjacency
        arenas directly) and propagate the changed-row set to whichever
        persistent mirrors are live — the host neighbor slab, the device
        delta arena, and the incremental-snapshot and checkpoint dirty
        trackers.  Everything here is O(changed rows)."""
        dirty_np = {
            l: np.unique(np.concatenate(parts).astype(np.int64))
            for l, parts in dirty.items()
            if parts
        }
        self.graph.version += 1
        if slab_live:
            self._slab.apply_deltas(self.graph, dirty_np)
        if arena is not None:
            arena.apply_deltas(self, dirty_np)
        for tr in (self._snap_tracker, self._ckpt_tracker):
            if not tr["all"]:
                for l, rows in dirty_np.items():
                    tr["dirty"].setdefault(l, []).append(rows)

    def _resolve_back_edge_overflow(
        self,
        overflow: dict[tuple[int, int], list[tuple[int, float]]],
        uvals: np.ndarray,
    ) -> None:
        """Terminal two-stage prune for every contended (layer, vertex) of a
        micro-batch: window-filter the vertex's kept neighbors (Alg. 1 line
        16, rank arithmetic over ``uvals``), join them with ALL its deferred
        back-edge arrivals, and RNG-prune each contended list — every list
        in one vectorised ``rng_prune_rows`` pass.  Equivalent to a
        sequential order in which each contended vertex's arrivals land
        consecutively and are pruned together."""
        p = self.params
        u = len(uvals)
        keys = list(overflow.keys())
        R = len(keys)
        # windows of every contended vertex in one vectorised rank pass
        l_arr = np.asarray([l for l, _ in keys], dtype=np.int64)
        t_arr = np.asarray([t for _, t in keys], dtype=np.int64)
        attr_t = self.store.attrs[t_arr]
        half = np.power(p.o, l_arr)
        rk = np.searchsorted(uvals, attr_t, side="left")
        lo_idx = np.maximum(0, rk - half)
        hi_idx = np.maximum(np.minimum(u - 1, rk + half), lo_idx)
        w_lo = np.minimum(uvals[lo_idx], attr_t)
        w_hi = np.maximum(uvals[hi_idx], attr_t)
        m = self.graph.m
        max_new = max(len(v) for v in overflow.values())
        width = m + max_new
        cand_ids = np.full((R, width), -1, dtype=np.int64)
        cand_d = np.full((R, width), np.inf, dtype=np.float64)
        kcnt = np.zeros(R, dtype=np.int64)
        col = np.arange(m)
        # window-filter + left-compact every contended vertex's kept
        # neighbors, grouped per layer (one gather + one argsort per layer)
        for l in np.unique(l_arr).tolist():
            idx = np.nonzero(l_arr == l)[0]
            t_sub = t_arr[idx]
            rows = self.graph.layers[l][t_sub].astype(np.int64)  # [k, m]
            valid = col[None, :] < self.graph.counts[l][t_sub][:, None]
            a = self.store.attrs[rows]
            keep = valid & (a >= w_lo[idx, None]) & (a <= w_hi[idx, None])
            if self.deleted:
                keep &= ~np.isin(rows, np.fromiter(self.deleted, dtype=np.int64))
            order = np.argsort(~keep, axis=1, kind="stable")
            ar = np.arange(len(idx))[:, None]
            rows_c = rows[ar, order]
            keep_c = keep[ar, order]
            cand_ids[idx, :m] = np.where(keep_c, rows_c, -1)
            kcnt[idx] = keep.sum(axis=1)
        self.build_stats.dc += int(kcnt.sum())
        # kept neighbors' distances to their owner, one batched call
        kd = self.store.dist_block(
            self.store.vectors[t_arr], np.maximum(cand_ids[:, :m], 0)
        ).astype(np.float64)
        cand_d[:, :m] = np.where(cand_ids[:, :m] >= 0, kd, np.inf)
        # deferred arrivals append after the kept prefix, in batch order
        for r, (l, t) in enumerate(keys):
            k = int(kcnt[r])
            for i, (vid, d_ab) in enumerate(overflow[(l, t)]):
                cand_ids[r, k + i] = vid
                cand_d[r, k + i] = d_ab
        sel_ids, _, sel_mask = rng_prune_rows(self.store, cand_ids, cand_d, p.m)
        for r, (l, t) in enumerate(keys):
            self.graph.set_neighbors(
                l, t, sel_ids[r][sel_mask[r]].astype(np.int32)
            )

    def _two_stage_prune(
        self, l: int, b: int, vid: int, d_ab: float, uvals: np.ndarray | None = None
    ) -> None:
        """Alg. 1 lines 15-17: window prune then RNG prune of b's list.

        ``uvals`` is an optional sorted snapshot of the unique values (the
        batched path computes it once per micro-batch): the window is then
        derived by rank arithmetic over it instead of two WBT traversals —
        identical bounds, no tree walk per back-edge."""
        p = self.params
        self.build_stats.prunes += 1
        attr_b = float(self.store.attrs[b])
        half = p.o**l
        if uvals is None:
            w_lo, w_hi = self.wbt.window(attr_b, half)
        else:
            u = len(uvals)
            rk = int(np.searchsorted(uvals, attr_b, side="left"))
            lo_idx = max(0, rk - half)
            hi_idx = max(min(u - 1, rk + half), lo_idx)
            w_lo = min(float(uvals[lo_idx]), attr_b)
            w_hi = max(float(uvals[hi_idx]), attr_b)
        vb = self.store.vectors[b]
        nbrs = self.graph.neighbors(l, b)
        a = self.store.attrs[nbrs]
        keep = nbrs[(a >= w_lo) & (a <= w_hi)]
        if self.deleted:
            keep = np.asarray(
                [j for j in keep.tolist() if j not in self.deleted], dtype=np.int64
            )
        ids = np.concatenate([[vid], keep.astype(np.int64)])
        dists = np.concatenate(
            [[d_ab], self.store.dist_batch(vb, keep).astype(np.float64)]
        )
        self.build_stats.dc += len(keep)
        sel_i, _ = rng_prune_ids(self.store, ids, dists, p.m)
        self.graph.set_neighbors(l, b, sel_i.astype(np.int32))

    def _pick_entry(
        self,
        uvals: np.ndarray,
        ks: np.ndarray,
        choice: np.ndarray,
        lo_r: int,
        hi_r: int,
        batch_set: set[int],
    ) -> int | None:
        """Alg. 1 line 7 for the batched path: try the 4 pre-sampled value
        ranks, then fall back to a linear sweep of the window — mirrors
        ``_sample_entry`` with the WBT walks replaced by rank lookups into
        the sorted-values snapshot (``uvals``)."""
        lo_r, hi_r = int(lo_r), int(hi_r)
        if hi_r < lo_r:
            return None
        for t in range(4):
            val = float(uvals[min(int(ks[t]), hi_r)])
            cands = [
                c
                for c in self.value_map.get(val, ())
                if c not in batch_set and c not in self.deleted
            ]
            if cands:
                return int(cands[int(choice[t] * len(cands)) % len(cands)])
        for k in range(lo_r, hi_r + 1):
            for c in self.value_map.get(float(uvals[k]), ()):
                if c not in batch_set and c not in self.deleted:
                    return int(c)
        return None

    def _sample_entry(
        self, w_lo: float, w_hi: float, exclude: int | set[int]
    ) -> int | None:
        """Alg. 1 line 7: a random vertex with attribute value in the window.

        ``exclude`` is the inserting vertex id, or — during batched
        construction — the whole pending micro-batch (its members have no
        committed edges yet, so they must not seed a search)."""
        if self.wbt.n == 0:
            return None
        excl = exclude if isinstance(exclude, set) else {exclude}
        lo = self.wbt.rank(w_lo)
        hi = self.wbt.count_le(w_hi) - 1
        if hi < lo:
            return None
        for _ in range(4):  # tolerate deleted / excluded hits
            k = int(self._rng.integers(lo, hi + 1))
            val = self.wbt.select(k)
            cands = [
                c for c in self.value_map.get(val, []) if c not in excl and c not in self.deleted
            ]
            if cands:
                return int(cands[self._rng.integers(0, len(cands))])
        # fall back to a linear-ish sweep over the window
        for k in range(lo, hi + 1):
            val = self.wbt.select(k)
            for c in self.value_map.get(val, []):
                if c not in excl and c not in self.deleted:
                    return int(c)
        return None

    # ---------------------------------------------------------------- search
    def landing_layer(self, n_prime: int) -> int:
        """Alg. 3 lines 2-3: selectivity-aware landing layer."""
        o = self.params.o
        top = self.graph.top
        if n_prime <= 0:
            return 0
        l_h = int(math.floor(math.log(max(n_prime, 1) / 2, o))) if n_prime >= 2 else 0
        l_h = max(0, min(l_h, top))
        best_l, best_ratio = 0, -1.0
        for l in (l_h, l_h + 1):
            if l > top:
                continue
            w = 2 * (o**l)
            ratio = min(w, n_prime) / max(w, n_prime)
            if ratio > best_ratio:
                best_ratio, best_l = ratio, l
        return best_l

    def search(
        self,
        q: np.ndarray,
        rng: tuple[float, float],
        k: int = 10,
        ef: int = 64,
        l_max: int | None = None,
        l_min: int = 0,
        stats: SearchStats | None = None,
        early_stop: bool = True,
    ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Algorithm 3: selectivity-aware RFANNS query.

        ``l_max`` overrides the landing layer (for the Fig. 7 ablation);
        ``stats`` may be supplied to accumulate instrumentation.
        """
        if stats is None:
            stats = SearchStats()
        x, y = float(rng[0]), float(rng[1])
        q = self.store.prepare(np.asarray(q))
        n_prime = self.selectivity(x, y)
        if n_prime == 0 or self.store.n == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32), stats
        l_d = self.landing_layer(n_prime) if l_max is None else min(l_max, self.graph.top)
        ep = self._entry_for_query(x, y)
        if ep is None:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32), stats
        width = max(ef, k)
        found = search_candidates(
            self.store,
            self.graph,
            self._visited,
            ep,
            q,
            (x, y),
            l_min=l_min,
            l_max=l_d,
            width=width,
            stats=stats,
            deleted=self.deleted or None,
            early_stop=early_stop,
        )
        found = found[:k]
        ids = np.asarray([j for _, j in found], dtype=np.int64)
        dists = np.asarray([d for d, _ in found], dtype=np.float32)
        return ids, dists, stats

    def _entry_for_query(self, x: float, y: float) -> int | None:
        """Alg. 3 line 4: vertex with value closest to the filter median."""
        val = self.wbt.closest_in_range((x + y) / 2.0, x, y)
        if val is None:
            return None
        cands = [c for c in self.value_map.get(val, []) if c not in self.deleted]
        if not cands:
            # duplicates of this value all deleted; scan outward by rank
            lo = self.wbt.rank(x)
            hi = self.wbt.count_le(y) - 1
            for kk in range(lo, hi + 1):
                for c in self.value_map.get(self.wbt.select(kk), []):
                    if c not in self.deleted:
                        return int(c)
            return None
        return int(cands[0])

    def selectivity(self, x: float, y: float) -> int:
        """Live ``n'`` for Alg. 3: unique values in [x, y] minus the *dead*
        ones (values whose duplicates are all deleted).  The WBT never
        removes values, so counting it alone leaves the landing layer
        computed from a stale selectivity after deletes."""
        n_prime = self.wbt.count_range(x, y)
        if self._dead_vals:
            n_prime -= bisect.bisect_right(self._dead_vals, y) - bisect.bisect_left(
                self._dead_vals, x
            )
        return n_prime

    def _note_live_insert(self, val: float) -> None:
        """Live-count bookkeeping for one committed insert of ``val``; a
        previously dead value is resurrected out of the dead list."""
        c = self._live_counts.get(val, 0)
        self._live_counts[val] = c + 1
        if c == 0 and self._dead_vals:
            i = bisect.bisect_left(self._dead_vals, val)
            if i < len(self._dead_vals) and self._dead_vals[i] == val:
                self._dead_vals.pop(i)

    # ---------------------------------------------------------------- delete
    def delete(self, vid: int) -> None:
        """Mark-based deletion (§3.7). The vertex stays traversable; the
        two-stage prune removes it from neighbor lists opportunistically.
        When a value's last live duplicate dies the value joins the dead
        list and stops counting toward query selectivity."""
        vid = int(vid)
        if not (0 <= vid < self.store.n) or vid in self.deleted:
            return
        if self._wal is not None and not self._wal_replaying:
            self._applied_lsn = self._wal.log_delete(vid)
        self.deleted.add(vid)
        self.mutations += 1
        # any change to the live set invalidates incremental snapshot
        # refresh: a compacted prev snapshot cannot be delta-extended even
        # if its id map LOOKS like an identity prefix (suffix-only deletes)
        self._snap_tracker["all"] = True
        val = float(self.store.attrs[vid])
        c = self._live_counts.get(val, 0) - 1
        self._live_counts[val] = c
        if c == 0:
            bisect.insort(self._dead_vals, val)

    def undelete(self, vid: int) -> None:
        """Undo a mark-based deletion (keeps the live-count/dead-value
        selectivity bookkeeping consistent — never mutate ``deleted``
        directly)."""
        vid = int(vid)
        if vid not in self.deleted:
            return
        if self._wal is not None and not self._wal_replaying:
            self._applied_lsn = self._wal.log_undelete(vid)
        self.deleted.discard(vid)
        self.mutations += 1
        self._snap_tracker["all"] = True  # live set changed (see delete)
        self._note_live_insert(float(self.store.attrs[vid]))

    def compact_rows(self) -> int:
        """Tombstone compaction pass (§3.7 maintenance): rebuild every
        neighbor row that references a deleted vertex from *live* candidates
        only, bounding recall decay on long-running ingest-while-serve
        deployments with deletes.

        For each contended (layer, vertex) row the candidate set is the
        row's kept live neighbors plus the live neighbors of each dropped
        tombstone (the tombstone's own adjacency approximates the
        neighborhood it was bridging — the standard graph-repair move), all
        window-filtered against the owner's layer window (Def. 4) and
        re-selected with the vectorised RNG prune.  Deleted vertices' own
        rows are rebuilt too (they remain traversable until compacted
        elsewhere).  Returns the number of rows rebuilt; O(contended rows),
        with the changed rows propagated to the persistent build arenas and
        snapshot tracker as deltas.
        """
        if not self.deleted or self.store.n == 0:
            return 0
        if self._wal is not None and not self._wal_replaying:
            self._applied_lsn = self._wal.log_compact()
        # compaction-cadence latch: tombstones at this pass are accounted
        # for — auto-compaction re-fires only once NEW ones accumulate.
        # Set unconditionally (manual or auto) so a WAL replay of the
        # COMPACT record reproduces the latch exactly.
        self._compact_dead_done = len(self.deleted)
        p = self.params
        n = self.store.n
        m = self.graph.m
        dead = np.fromiter(
            self.deleted, dtype=np.int64, count=len(self.deleted)
        )
        uvals = np.fromiter(
            self.value_map.keys(), dtype=np.float64, count=len(self.value_map)
        )
        uvals.sort()
        u = len(uvals)
        # arena liveness must be judged BEFORE this pass mutates anything:
        # a mirror already out of sync keeps its stale version and does a
        # full (amortised) rebuild at its next ensure instead.
        slab_ok = (
            self._slab.arr is not None
            and self._slab.version == self.graph.version
            and self._slab.top == self.graph.top
            and self._slab.cap == self.graph.capacity
        )
        arena_ok = (
            self._arena is not None
            and self._arena.version == self.graph.version
            and self._arena.num_layers == self.graph.num_layers
            and self._arena.cap == self.graph.capacity
        )
        rebuilt = 0
        dirty: dict[int, list[np.ndarray]] = {}
        col = np.arange(m)[None, :]
        for l in range(self.graph.num_layers):
            rows = self.graph.layers[l][:n]
            valid = col < self.graph.counts[l][:n][:, None]
            contended = (valid & np.isin(rows, dead)).any(axis=1)
            own = np.nonzero(contended)[0].astype(np.int64)
            if own.size == 0:
                continue
            R = len(own)
            arR = np.arange(R)[:, None]
            rows_b = rows[own].astype(np.int64)  # [R, m]
            valid_b = valid[own]
            is_dead = np.isin(rows_b, dead) & valid_b
            keep = valid_b & ~is_dead
            # repair candidates: the dropped tombstones' own live neighbors
            parents = np.where(is_dead, rows_b, -1)
            rep = rows[np.maximum(parents, 0)].astype(np.int64)  # [R, m, m]
            rep_ok = (parents[:, :, None] >= 0) & (rep >= 0)
            rep_ok &= ~np.isin(rep, dead)
            rep_ok &= rep != own[:, None, None]
            cand = np.concatenate(
                [np.where(keep, rows_b, -1),
                 np.where(rep_ok, rep, -1).reshape(R, m * m)],
                axis=1,
            )  # [R, m + m*m]
            # owner's window at this layer (rank arithmetic, Def. 4)
            attr_o = self.store.attrs[own]
            half = p.o**l
            rk = np.searchsorted(uvals, attr_o, side="left")
            lo_idx = np.maximum(0, rk - half)
            hi_idx = np.maximum(np.minimum(u - 1, rk + half), lo_idx)
            w_lo = np.minimum(uvals[lo_idx], attr_o)
            w_hi = np.maximum(uvals[hi_idx], attr_o)
            a = self.store.attrs[np.maximum(cand, 0)]
            ok = (cand >= 0) & (a >= w_lo[:, None]) & (a <= w_hi[:, None])
            cand = np.where(ok, cand, -1)
            # id-sort dedupe (repair lists overlap the kept prefix)
            key = np.where(cand >= 0, cand, np.int64(2**62))
            order = np.argsort(key, axis=1, kind="stable")
            ks = key[arR, order]
            dup = np.zeros(ks.shape, dtype=bool)
            dup[:, 1:] = ks[:, 1:] == ks[:, :-1]
            cand = np.where(dup | (ks == 2**62), -1, cand[arR, order])
            d = self.store.dist_block(
                self.store.vectors[own], np.maximum(cand, 0)
            ).astype(np.float64)
            d = np.where(cand >= 0, d, np.inf)
            self.build_stats.dc += int((cand >= 0).sum())
            self.build_stats.prunes += R
            T = max(2 * m, 8)  # nearest-T pre-truncation (as in phase 2)
            if cand.shape[1] > T:
                part = np.argpartition(d, T - 1, axis=1)[:, :T]
                cand = cand[arR, part]
                d = d[arR, part]
            sel_ids, _, sel_mask = rng_prune_rows(self.store, cand, d, m)
            self.graph.layers[l][own] = np.where(
                sel_mask, sel_ids, -1
            ).astype(np.int32)
            self.graph.counts[l][own] = sel_mask.sum(axis=1).astype(np.int32)
            dirty[l] = [own]
            rebuilt += R
        if rebuilt:
            self.mutations += 1
            self._commit_deltas(
                dirty,
                self._arena if arena_ok else None,
                slab_ok,
            )
        return rebuilt

    # ----------------------------------------------------- durable lifecycle
    @classmethod
    def recover(cls, root: str, device=None) -> "WoWIndex":
        """Crash recovery: newest valid checkpoint under ``root`` + replay
        of the valid WAL suffix (torn tails truncated cleanly), building on
        ``device`` (None = the CUDA card).  See ``repro_torch.persist.
        recovery``; ``repro_torch.persist.open_durable`` also attaches the
        WAL for continued durable ingest."""
        from ..persist.recovery import recover as _recover

        return _recover(root, device=device)

    def checkpoint(self, root: str, incremental: bool = True) -> str:
        """Write a (full or incremental) checkpoint under ``root`` — see
        ``repro_torch.persist.checkpoint.save``.  Returns its path."""
        from ..persist.checkpoint import save as _save

        return _save(self, root, incremental=incremental)

    # ------------------------------------------------------------- reporting
    def memory_bytes(self) -> int:
        g = sum(lay.nbytes + cnt.nbytes for lay, cnt in zip(self.graph.layers, self.graph.counts))
        w = self.wbt.val.nbytes + self.wbt.left.nbytes + self.wbt.right.nbytes + self.wbt.size.nbytes
        return g + w  # raw vectors/attrs excluded, as in Table 4

    def describe(self) -> dict:
        return {
            "n": self.store.n,
            "unique": self.wbt.n,
            "layers": self.graph.num_layers,
            "m": self.params.m,
            "o": self.params.o,
            "index_bytes": self.memory_bytes(),
            "build_dc": self.build_stats.dc,
            "searches_skipped": self.build_stats.searches_skipped,
        }
