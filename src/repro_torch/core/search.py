"""Algorithm 2 (``SearchCandidates``) and RNG pruning — host reference path.

This is the faithful, instrumented implementation of the paper's multi-layer
beam search with:

  * top-down layer traversal per hop, starting at ``l_max`` (the landing
    layer during queries, the insertion layer during builds),
  * the **early-stop** flag ``next`` — descend a layer only if some neighbor
    at the current layer failed the range filter,
  * the per-hop **distance-computation cap** ``c_n <= m`` with high-layer
    priority (Alg. 2 lines 9-11),
  * out-of-range vertices are *never* distance-evaluated (no-OOR, Table 2).

The per-hop layer sweep is evaluated with vectorised numpy mask algebra and
distances for a hop are computed as one batch; the set of evaluated vertices
and the push order are exactly those of the paper's sequential loop (the
``c_n`` cap and the layer priority are distance-independent, and out-of-range
neighbors are never marked visited within a hop, so the early-stop flag per
layer equals "any unvisited out-of-range neighbor" evaluated up front).
DC counts therefore match the sequential formulation; filter-check counts can
differ by the rare in-hop duplicate of an already-evaluated neighbor.

The device serving path (``repro_torch.core.device_search``) re-implements the same
semantics as a torch hop loop; parity is enforced by tests.
"""
from __future__ import annotations

import heapq

import numpy as np

from .graph import LayeredGraph
from .store import SearchStats, VectorStore


class _Visited:
    """O(1) clearable visited set via generation stamping (python list —
    scalar indexing on the hot path is ~3x faster than numpy scalars)."""

    __slots__ = ("gen", "cur")

    def __init__(self, capacity: int = 1024):
        self.gen: list[int] = [0] * capacity
        self.cur = 0

    def next_query(self, n: int) -> None:
        if n > len(self.gen):
            self.gen.extend([0] * (max(n, 2 * len(self.gen)) - len(self.gen)))
        self.cur += 1

    def test_and_set(self, v: int) -> bool:
        if self.gen[v] == self.cur:
            return True
        self.gen[v] = self.cur
        return False

    def is_visited(self, v: int) -> bool:
        return self.gen[v] == self.cur


class VisitedArena2D:
    """Generation-stamped 2-D visited arena — the batched twin of
    ``_Visited`` for ``search_candidates_batch``.

    One persistent ``uint8[Bcap, ncap]`` stamp array replaces the fresh
    ``bool[B, n]`` bitmap the batched search used to zero per call (same
    byte footprint): a cell is visited iff its stamp equals the current
    generation, and "clearing" for a new search is one counter bump (a
    cheap full re-zero every 255 generations handles stamp wrap).
    Capacity grows by doubling (amortised — the arena is reallocated
    O(log) times over an index's life, never per micro-batch), which is
    what makes the construction batch loop free of Theta(n) allocations.
    ``stats`` counts (re)allocations so regression tests can pin the
    once-only behaviour down.
    """

    __slots__ = ("arr", "bcap", "ncap", "cur", "stats")

    def __init__(self, bcap: int = 8, ncap: int = 1024):
        self.bcap = max(int(bcap), 1)
        self.ncap = max(int(ncap), 1)
        self.arr = np.zeros(self.bcap * self.ncap, dtype=np.uint8)
        self.cur = 0
        self.stats = {"allocs": 1, "searches": 0}

    def begin(self, b: int, n: int) -> tuple[np.ndarray, int, int]:
        """Start a search over ``b`` members against ``n`` vertices: grow if
        needed, bump the generation, and return ``(flat_arr, cur, ncap)``.
        Row ``r``'s cell for vertex ``v`` lives at ``r * ncap + v``."""
        if b > self.bcap or n > self.ncap:
            while self.bcap < b:
                self.bcap *= 2
            while self.ncap < n:
                self.ncap *= 2
            self.arr = np.zeros(self.bcap * self.ncap, dtype=np.uint8)
            self.cur = 0
            self.stats["allocs"] += 1
        if self.cur >= 255:  # uint8 stamp wrap: hard reset
            self.arr.fill(0)
            self.cur = 0
        self.cur += 1
        self.stats["searches"] += 1
        return self.arr, self.cur, self.ncap


def hash_positions_np(ids, v_bits: int, nh: int):
    """Blocked-Bloom probe positions, numpy: ids int[...] -> uint32[..., nh]
    in [0, v_bits) (power-of-two ``v_bits``).  Bit-identical to the device
    filter in ``repro_torch.core.device_search`` — one murmur3 fmix32 hash whose
    low bits pick the id's 32-bit block and whose bits 16+ derive ``nh``
    distinct bit offsets inside it (``(b0 + i*step) & 31`` with odd
    step)."""
    with np.errstate(over="ignore"):
        h = np.asarray(ids).astype(np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
        word = h & np.uint32(v_bits // 32 - 1)
        b0 = (h >> np.uint32(16)) & np.uint32(31)
        step = ((h >> np.uint32(21)) & np.uint32(31)) | np.uint32(1)
        i = np.arange(nh, dtype=np.uint32)
        bits = (b0[..., None] + i * step[..., None]) & np.uint32(31)
        return word[..., None] * np.uint32(32) + bits


class _HashGen:
    """Adapter giving ``HashedVisited`` the ``gen[v] == cur`` /
    ``gen[v] = cur`` stamp protocol that ``search_candidates`` inlines on
    its hot path (so the filter is a drop-in for ``_Visited`` without
    slowing the exact path down with per-neighbor dispatch)."""

    __slots__ = ("owner",)

    def __init__(self, owner: "HashedVisited"):
        self.owner = owner

    def __getitem__(self, v: int) -> int:
        o = self.owner
        return o.cur if o.is_visited(v) else o.cur - 1

    def __setitem__(self, v: int, _val: int) -> None:
        o = self.owner
        o.bits[o._pos(v)] = o.cur


class HashedVisited:
    """Host twin of the device double-hashed visited filter.

    Drop-in for ``_Visited`` in ``search_candidates`` (same
    ``next_query``/``test_and_set``/``is_visited``/``gen`` interface, same
    generation-stamp clearing) but membership is the AND of ``nh``
    double-hashed probe bits over a constant ``v_bits``-bit ring — the
    exact probe arithmetic of ``device_search(..., visited="hash")``.
    A false positive makes the filter report an unvisited vertex as
    visited, i.e. the search *skips* it; it can never admit an extra
    evaluation, so the host path under this filter brackets the device
    hash path's skip behaviour for tests.
    """

    __slots__ = ("bits", "v_bits", "nh", "cur")

    def __init__(self, v_bits: int = 1 << 14, nh: int = 2):
        assert v_bits & (v_bits - 1) == 0, "v_bits must be a power of two"
        self.v_bits, self.nh = v_bits, nh
        self.bits = np.zeros(v_bits, np.int64)  # generation stamp per bit
        self.cur = 0

    @property
    def gen(self) -> _HashGen:
        return _HashGen(self)

    def next_query(self, n: int) -> None:  # n unused: size is budget-bound
        self.cur += 1

    def _pos(self, v: int):
        return hash_positions_np(np.asarray([v]), self.v_bits, self.nh)[0]

    def test_and_set(self, v: int) -> bool:
        if self.is_visited(v):
            return True
        self.bits[self._pos(v)] = self.cur
        return False

    def is_visited(self, v: int) -> bool:
        return bool(np.all(self.bits[self._pos(v)] == self.cur))


def search_candidates(
    store: VectorStore,
    graph: LayeredGraph,
    visited: _Visited,
    ep: int,
    target: np.ndarray,
    rng: tuple[float, float],
    l_min: int,
    l_max: int,
    width: int,
    stats: SearchStats,
    exclude: int = -1,
    deleted: set[int] | None = None,
    early_stop: bool = True,
) -> list[tuple[float, int]]:
    """Returns up to ``width`` nearest in-range candidates as (dist, id),
    sorted ascending by distance."""
    x, y = rng
    attrs = store.attrs_list
    vectors = store.vectors
    metric = store.metric
    norms = store.sq_norms
    q2 = float(np.dot(target, target))
    m = graph.m
    layer_rows = [lay for lay in graph.layers]
    layer_cnts = [cnt for cnt in graph.counts]
    visited.next_query(store.n)
    gen = visited.gen
    cur = visited.cur
    stats.lowest_layer = l_max

    d_ep = float(store.dist_batch(target, np.asarray([ep]))[0])
    stats.dc += 1
    gen[ep] = cur
    # C: min-heap of unexpanded candidates; U: max-heap (negated) of results.
    C: list[tuple[float, int]] = [(d_ep, ep)]
    U: list[tuple[float, int]] = [(-d_ep, ep)]

    dc = 0
    filter_checks = 0
    hops = 0
    lowest = l_max
    heappush, heappop = heapq.heappush, heapq.heappop
    while C:
        d_s, s = heappop(C)
        if len(U) >= width and d_s > -U[0][0]:
            break
        hops += 1
        # ---- top-down layer sweep (Alg. 2 lines 7-17) ----
        batch: list[int] = []
        c_n = 0
        l = l_max
        nxt = True
        while l >= l_min and nxt:
            nxt = not early_stop  # ablation: always descend (Table 5)
            if l < lowest:
                lowest = l
            cnt = int(layer_cnts[l][s])
            if cnt:
                row = layer_rows[l][s, :cnt].tolist()
                for j in row:
                    if gen[j] == cur:
                        continue
                    filter_checks += 1
                    a = attrs[j]
                    if a < x or a > y:
                        nxt = True
                    elif c_n <= m:
                        gen[j] = cur
                        c_n += 1
                        batch.append(j)
            l -= 1
        # ---- batched distance evaluation + heap pushes ----
        if batch:
            xv = vectors[batch]
            if metric == "l2":
                # |v|^2 - 2 v.q + |q|^2 with cached |v|^2 (same MXU-friendly
                # factorisation the CUDA kernel uses)
                dists = norms[batch] - 2.0 * np.dot(xv, target) + q2
                np.maximum(dists, 0.0, out=dists)
            else:
                dists = 1.0 - np.dot(xv, target)
            dc += len(batch)
            for j, dj in zip(batch, dists.tolist()):
                if j == exclude:
                    continue
                if len(U) < width or dj < -U[0][0]:
                    heappush(C, (dj, j))
                    # deleted vertices stay traversable but are never results
                    # (§3.7: "normally traverse it without pushing it into
                    # the result max-heap").
                    if deleted is None or j not in deleted:
                        heappush(U, (-dj, j))
                        if len(U) > width:
                            heappop(U)
    stats.dc += dc
    stats.filter_checks += filter_checks
    stats.hops += hops
    stats.lowest_layer = max(min(stats.lowest_layer, lowest), l_min)
    out = [(-nd, i) for nd, i in U]
    out.sort()
    return out


def search_candidates_batch(
    store: VectorStore,
    graph: LayeredGraph,
    targets: np.ndarray,
    eps: np.ndarray,
    ranges: np.ndarray,
    l_min: int,
    l_max: int,
    width: int,
    deleted: set[int] | None = None,
    early_stop: bool = True,
    backend: str = "numpy",
    slab_cache: np.ndarray | None = None,
    ops_table=None,
    ops_scales=None,
    seed_ids: np.ndarray | None = None,
    seed_d: np.ndarray | None = None,
    visited_arena: "VisitedArena2D | None" = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Lock-step batched ``SearchCandidates`` (Alg. 2) for B independent
    targets over the *live* host graph — the construction twin of the device
    hop loop in ``repro_torch.core.device_search``, and the engine under
    ``WoWIndex.insert_batch``.

    Per hop, every still-active member selects its nearest unexpanded beam
    entry; the neighbor blocks of ALL swept layers are gathered as one
    [Ba, L*m] slab, the early-stop layer mask is evaluated vectorially
    (a layer below ``l`` contributes only if every layer above it had an
    unvisited out-of-range neighbor — out-of-range vertices are never
    marked visited inside a hop, so the flags are data-parallel computable
    up front, exactly as on the device path), duplicates across layers are
    dropped by a packed single-key sort (id-major, layer-priority rank
    minor — the device pipeline's dedupe), the per-hop ``c_n <= m`` cap
    admits the best-ranked ``m+1`` survivors, and all members' admitted
    neighbors are distance-evaluated in ONE batched BLAS contraction
    (``backend="numpy"``, via ``VectorStore.dist_block``) or one fused
    gather+distance kernel dispatch (``backend="ops"``, via
    ``repro_torch.kernels.ops.gather_norm_dot`` — the serving path's
    machinery) against ``ops_table`` (the device vector arena, with its
    int8 ``ops_scales``), or against the store's rows uploaded to
    ``device`` (``None`` = the CUDA card) when no table is given.

    Like the device path, the width-W sorted beam doubles as the candidate
    heap (entries beyond W can never be expanded by the paper's algorithm
    either); ``search_candidates`` stays the sequential parity oracle.
    Deleted vertices remain traversable (they occupy beam slots and are
    expanded) but are masked out of the returned candidate arrays (§3.7).

    Args:
        targets: f32 [B, d] prepared query vectors.
        eps:     int [B] entry vertex per member.
        ranges:  f64 [B, 2] per-member (lo, hi) attribute windows.

    Returns ``(res_i, res_d, dc, hops, filter_checks)``: per-member sorted
    candidate ids [B, W] (-1 padded, deleted masked out) with distances
    [B, W], plus per-member instrumentation (DC accounting preserved per
    insert).

    ``visited_arena`` supplies a persistent generation-stamped 2-D visited
    arena (``VisitedArena2D``) so repeated calls — the per-layer searches of
    a micro-batch build loop — share one allocation instead of zeroing a
    fresh Theta(B*n) bitmap each; omitted, a transient arena is created
    (same code path, same cost profile as the old bitmap).
    """
    if backend not in ("numpy", "ops"):
        # this host engine only knows the two hop-eval routes; a typo'd
        # backend must not silently degrade to the numpy path
        raise ValueError(
            f"unknown search_candidates_batch backend {backend!r}; "
            "registered backends: numpy, ops"
        )
    B = len(eps)
    n = store.n
    W = int(width)
    m = graph.m
    attrs = store.attrs[:n]
    xs = np.ascontiguousarray(ranges[:, 0], dtype=np.float64)
    ys = np.ascontiguousarray(ranges[:, 1], dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float32).reshape(B, store.dim)
    eps = np.asarray(eps, dtype=np.int64).reshape(B)
    q2 = np.einsum("bd,bd->b", targets, targets)

    vec_tab = store.vectors
    nrm_tab = store.sq_norms
    metric_l2 = store.metric == "l2"
    sparse_eval = backend != "ops"
    if backend == "ops":
        import torch

        from .. import resolve_device
        from ..kernels.ops import gather_norm_dot

        # ops_table caches the device-side copy across the calls of one
        # frozen-graph phase (a micro-batch insert runs one search per
        # layer — re-uploading the [n, d] table each time would dominate)
        if ops_table is not None:
            table, scales = ops_table, ops_scales
        else:
            table = torch.from_numpy(
                np.ascontiguousarray(store.vectors[:n])).to(
                    resolve_device(device))
            scales = None
        tdev = table.device

        def eval_ids(tg_sub, q2_sub, ids_pad):
            dots, norms = gather_norm_dot(
                table,
                torch.from_numpy(np.asarray(ids_pad, np.int64)).to(tdev),
                torch.from_numpy(np.ascontiguousarray(tg_sub)).to(tdev),
                scales=scales,
            )
            dots, norms = dots.cpu().numpy(), norms.cpu().numpy()
            if store.metric == "l2":
                d = norms - 2.0 * dots + q2_sub[:, None]
                return np.maximum(d, 0.0)
            return 1.0 - dots
    else:

        def eval_ids(tg_sub, q2_sub, ids_pad):
            # inlined VectorStore.dist_block against cached q2 (one gather +
            # one batched BLAS contraction)
            x = vec_tab[ids_pad]
            dots = np.einsum("bkd,bd->bk", x, tg_sub)
            if store.metric == "l2":
                d = nrm_tab[ids_pad] - 2.0 * dots + q2_sub[:, None]
                np.maximum(d, 0.0, out=d)
                return d
            return 1.0 - dots

    # ---- compacted working state (the device path's ragged-batch
    # compaction, host edition): every per-hop op runs on the active rows
    # plus a bounded fraction of retired stragglers; when the active
    # fraction drops below the threshold the whole state compacts ----
    org = np.arange(B)  # current row -> original member (== visited row)
    tg = targets
    q2c = q2
    xc, yc = xs, ys
    rd = np.full((B, W), np.inf, dtype=np.float32)
    ri = np.full((B, W), -1, dtype=np.int32)
    re = np.zeros((B, W), dtype=bool)
    # generation-stamped visited state: member b's cell for vertex v lives
    # at varr[b * ncap + v]; visited iff the stamp equals this search's
    # generation.  A caller-owned arena makes this allocation-free.
    varr, vcur, ncap = (visited_arena or VisitedArena2D(B, n)).begin(B, n)
    dcc = np.zeros(B, dtype=np.int64)
    if seed_ids is not None and seed_ids.size:
        # multi-seed: preload the beam with the caller's already-evaluated
        # candidates (the Thm-3.1 carry during builds) — their distances
        # are known, so they cost no DC and no re-discovery hops
        S = min(seed_ids.shape[1], W)
        sdist = np.where(seed_ids >= 0, seed_d, np.inf)
        so = np.argsort(sdist, axis=1, kind="stable")[:, :S]
        arB = np.arange(B)[:, None]
        rd[:, :S] = sdist[arB, so].astype(np.float32)
        ri[:, :S] = np.where(
            np.isfinite(rd[:, :S]), seed_ids[arB, so], -1
        ).astype(np.int32)
        sb, sc = np.nonzero(ri[:, :S] >= 0)
        varr[sb.astype(np.int64) * ncap + ri[sb, sc]] = vcur
        has_seed = ri[:, 0] >= 0
    else:
        has_seed = np.zeros(B, dtype=bool)
    noseed = np.nonzero(~has_seed)[0]
    if noseed.size:  # Alg. 1 line 7 entries for members with no carry
        varr[noseed.astype(np.int64) * ncap + eps[noseed]] = vcur
        rd[noseed, 0] = eval_ids(
            tg[noseed], q2[noseed], eps[noseed, None].astype(np.int32)
        )[:, 0]
        ri[noseed, 0] = eps[noseed]
        dcc[noseed] = 1  # the entry evaluation
    hoc = np.zeros(B, dtype=np.int64)
    fcc = np.zeros(B, dtype=np.int64)
    act = np.ones(B, dtype=bool)

    out_i = np.full((B, W), -1, dtype=np.int32)
    out_d = np.full((B, W), np.inf, dtype=np.float32)
    out_dc = np.zeros(B, dtype=np.int64)
    out_hops = np.zeros(B, dtype=np.int64)
    out_fc = np.zeros(B, dtype=np.int64)

    def retire(rows: np.ndarray) -> None:
        idx = org[rows]
        out_i[idx] = ri[rows]
        out_d[idx] = rd[rows]
        out_dc[idx] = dcc[rows]
        out_hops[idx] = hoc[rows]
        out_fc[idx] = fcc[rows]

    L_span = l_max - l_min + 1
    F = L_span * m
    # one [n, F] top-down neighbor slab per call: the whole layer sweep of
    # a hop is then a single row gather, and the -1 padding doubles as the
    # validity mask (no counts needed).  ``slab_cache`` (a full
    # [n, (l_max+1)*m] top-down slab built once per frozen-graph phase,
    # e.g. a micro-batch insert) supplies the prefix view instead.
    if slab_cache is not None:
        slab = slab_cache[:, :F]
    else:
        slab = np.stack(
            [graph.layers[l][:n] for l in range(l_max, l_min - 1, -1)], axis=1
        ).reshape(n, F)
    slot = np.arange(F, dtype=np.int32)  # layer-major rank (sweep order)
    K = m + 1  # the c_n cap admits at most m+1 neighbors per hop
    BIG = 2**30
    # pack (id, rank) into one bit-shifted sortable key (the device
    # pipeline's packed single-key dedupe); int32 sorts ~2x faster
    shift = 8 if F + 1 <= 256 else 16
    key_dtype = np.int32 if (n << shift) < 2**31 - 1 else np.int64
    rank_mask = (1 << shift) - 1
    guard = 0

    # per-row index scaffolding changes only at compaction events; visited
    # offsets address the arena by ORIGINAL member row (compaction slices
    # ``org``, never the arena)
    Bc = B
    aba = np.arange(Bc)[:, None]
    off_n = org[:, None].astype(np.int64) * ncap
    off_f = aba * np.int64(F)
    while guard <= n + 2:  # each hop expands >= 1 distinct vertex per member
        guard += 1
        all_active = bool(act.all())
        if all_active:
            masked = np.where(re, np.inf, rd)
        else:
            masked = np.where(re | ~act[:, None], np.inf, rd)
        jbest = np.argmin(masked, axis=1)
        dbest = masked[np.arange(Bc), jbest]
        worst = rd[:, W - 1]  # +inf while the beam is not full
        done = act & (~np.isfinite(dbest) | (dbest > worst))
        any_done = bool(done.any())
        if any_done:
            retire(done)
            act &= ~done
            na = int(act.sum())
            if na == 0:
                break
            if na < 0.6 * Bc and Bc > 8:  # compact the stragglers
                keep = act
                org, tg, q2c = org[keep], tg[keep], q2c[keep]
                xc, yc = xc[keep], yc[keep]
                rd, ri, re = rd[keep], ri[keep], re[keep]
                dcc, hoc, fcc = dcc[keep], hoc[keep], fcc[keep]
                act = np.ones(len(org), dtype=bool)
                Bc = len(org)
                aba = np.arange(Bc)[:, None]
                off_n = org[:, None].astype(np.int64) * ncap
                off_f = aba * np.int64(F)
                continue
        sel_all = all_active and not any_done
        sel = act
        if sel_all:
            re[np.arange(Bc), jbest] = True
            hoc += 1
        else:
            nsel = np.nonzero(sel)[0]
            if nsel.size == 0:
                continue
            re[nsel, jbest[nsel]] = True
            hoc[sel] += 1
        s = np.maximum(ri[np.arange(Bc), jbest], 0)
        # ---- flattened top-down layer sweep (Alg. 2 lines 7-17) ----
        # pad slots read as id -1: every consumer is masked by ``valid``
        # (wrap-mode takes make the stray gathers harmless).  Gathers go
        # through flat np.take — measurably faster than 2D fancy indexing.
        safe = slab[s]  # [Bc, F] int32; -1 pads ARE the validity mask
        valid = safe >= 0
        unv = valid & (varr.take(off_n + safe, mode="wrap") != vcur)
        if not sel_all:
            unv &= sel[:, None]
        a = attrs.take(safe, mode="wrap")
        in_r = (a >= xc[:, None]) & (a <= yc[:, None])
        elig = unv & in_r
        if early_stop:
            # layer l+1's "descend" flag: any unvisited out-of-range
            # neighbor (unv ^ elig == unvisited-and-OOR, one pass)
            oor = (unv ^ elig).reshape(Bc, L_span, m).any(axis=2)
            incl = np.ones((Bc, L_span), dtype=bool)
            if L_span > 1:
                incl[:, 1:] = np.logical_and.accumulate(oor[:, :-1], axis=1)
            unv3 = unv.reshape(Bc, L_span, m)
            unv3 &= incl[:, :, None]
            elig3 = elig.reshape(Bc, L_span, m)
            elig3 &= incl[:, :, None]
        fcc += unv.sum(axis=1)
        # ---- packed single-key sort dedupe + c_n cap (device pipeline) ----
        rank = np.where(elig, slot[None, :], np.int32(F))
        if key_dtype is np.int32:
            key = (safe << shift) | rank
        else:
            key = (safe.astype(np.int64) << shift) | rank.astype(np.int64)
        key.sort(axis=1)
        ids_s = key >> shift
        rank_s = key & rank_mask
        first = np.empty((Bc, F), dtype=bool)
        first[:, 0] = True
        np.not_equal(ids_s[:, 1:], ids_s[:, :-1], out=first[:, 1:])
        # ineligible slots carry rank F, which the "< F" admission mask
        # rejects — no separate eligibility AND is needed
        surv_rank = np.where(first, rank_s, np.int32(BIG))
        # the admitted set is the K smallest ranks among survivors; a small
        # second-stage sort packs valid lanes into a per-row prefix so the
        # eval/merge width can shrink to the hop's max admission count
        if F > K:
            order = np.argpartition(surv_rank, K - 1, axis=1)[:, :K]
        else:
            order = np.argsort(surv_rank, axis=1, kind="stable")[:, :K]
        sub = surv_rank.ravel().take(off_f + order)
        o2 = np.argsort(sub, axis=1, kind="stable")
        Ko = order.shape[1]
        flat_o = aba * np.int32(Ko) + o2
        order = order.ravel().take(flat_o)
        mask = sub.ravel().take(flat_o) < F  # valid lanes are a prefix
        if not mask.any():
            continue
        kmax = int(mask.sum(axis=1).max())
        order = order[:, :kmax]
        mask = mask[:, :kmax]
        adm_ids = ids_s.ravel().take(off_f + order).astype(np.int32)
        nb, ncol = np.nonzero(mask)
        ids_f = adm_ids[nb, ncol]
        varr[org[nb].astype(np.int64) * ncap + ids_f] = vcur
        # ---- one batched distance evaluation for the whole hop ----
        if sparse_eval:
            # only the admitted lanes (~40% of the dense [Bc, K] block)
            xf = vec_tab[ids_f]
            dotf = np.einsum("nd,nd->n", xf, tg[nb])
            if metric_l2:
                df = nrm_tab[ids_f] - 2.0 * dotf + q2c[nb]
                np.maximum(df, 0.0, out=df)
            else:
                df = 1.0 - dotf
            dists = np.full((Bc, kmax), np.inf, dtype=np.float32)
            dists[nb, ncol] = df
        else:
            dists = eval_ids(tg, q2c, adm_ids)
            dists = np.where(mask, dists, np.inf).astype(np.float32, copy=False)
        dcc += mask.sum(axis=1)
        # ---- stable merge into the sorted width-W beam ----
        cat_d = np.concatenate([rd, dists], axis=1)
        cat_i = np.concatenate([ri, np.where(mask, adm_ids, -1)], axis=1)
        cat_e = np.concatenate([re, np.zeros_like(mask)], axis=1)
        WK = cat_d.shape[1]
        if metric_l2 and WK <= 256:
            # l2 distances are non-negative, so the f32 bit pattern is
            # order-preserving as an int: pack (dist_bits, source slot)
            # into one int64 and use a DIRECT sort — cheaper than argsort's
            # indirection, bitwise the same stable order
            key = (cat_d.view(np.int32).astype(np.int64) << 8) | np.arange(
                WK, dtype=np.int64
            )
            key.sort(axis=1)
            order = (key[:, :W] & 0xFF).astype(np.int64)
        else:
            order = np.argsort(cat_d, axis=1, kind="stable")[:, :W]
        flat = (aba * np.int32(WK)) + order
        rd = cat_d.ravel().take(flat)
        ri = cat_i.ravel().take(flat)
        re = cat_e.ravel().take(flat)

    if act.any():
        retire(act)
    if deleted:
        dead = out_i >= 0
        dead &= np.isin(
            out_i, np.fromiter(deleted, dtype=np.int64, count=len(deleted))
        )
        out_i = np.where(dead, -1, out_i)
    return out_i, out_d, out_dc, out_hops, out_fc


def rng_prune(
    store: VectorStore,
    target: np.ndarray,
    candidates: list[tuple[float, int]],
    max_m: int,
) -> list[tuple[float, int]]:
    """RNG-based neighbor selection (HNSW 'heuristic'; Def. 4 property 1).

    Keep candidate ``c`` (nearest first) iff for every already-kept ``s``:
    ``dist(target, c) < dist(c, s)`` — i.e. the edge (target, c) is not the
    longest edge of any triangle with a kept neighbor.  The candidate-to-kept
    distances come from one BLAS pairwise matrix.

    Leftover slots are backfilled with the nearest pruned candidates
    (hnswlib's ``keepPrunedConnections``): in duplicate-heavy attribute
    regions the RNG filter alone can leave vertices under-connected, which
    measurably costs recall.
    """
    cand = sorted(set(candidates), key=lambda t: t[0])
    if not cand:
        return []
    # Short-circuit: a candidate set that already fits needs no pruning, and
    # with max_m == 1 the prune always keeps exactly the nearest candidate.
    # (Historically written as the chained comparison `len(cand) <= max_m
    # == 1`, which only ever fired for max_m == 1.)
    if len(cand) <= max_m or max_m == 1:
        return cand[:max_m]
    ids = np.asarray([j for _, j in cand], dtype=np.int64)
    xs = store.vectors[ids]
    if store.metric == "l2":
        sq = np.einsum("ij,ij->i", xs, xs)
        pair = sq[:, None] + sq[None, :] - 2.0 * (xs @ xs.T)
    else:
        pair = 1.0 - xs @ xs.T
    selected: list[tuple[float, int]] = []
    sel_rows: list[int] = []
    pruned: list[tuple[float, int]] = []
    for i, (d, j) in enumerate(cand):
        if len(selected) >= max_m:
            break
        ok = True
        for r in sel_rows:
            if pair[i, r] <= d:
                ok = False
                break
        if ok:
            selected.append((d, j))
            sel_rows.append(i)
        else:
            pruned.append((d, j))
    if len(selected) < max_m:  # keepPrunedConnections backfill
        selected.extend(pruned[: max_m - len(selected)])
    return selected


def rng_prune_ids(
    store: VectorStore,
    ids: np.ndarray,
    dists: np.ndarray,
    max_m: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Array-core RNG prune — the same selection rule and
    keepPrunedConnections backfill as ``rng_prune`` over parallel
    ``(ids, dists)`` arrays of *unique* ids (candidates from the batched
    machinery are deduplicated by construction, so the tuple/set plumbing
    of the list API is pure overhead there)."""
    if ids.size == 0:
        return ids[:0], dists[:0]
    order = np.argsort(dists, kind="stable")
    ids = ids[order]
    dists = dists[order]
    if len(ids) <= max_m or max_m == 1:
        return ids[:max_m], dists[:max_m]
    xs = store.vectors[ids]
    if store.metric == "l2":
        sq = np.einsum("ij,ij->i", xs, xs)
        pair = sq[:, None] + sq[None, :] - 2.0 * (xs @ xs.T)
    else:
        pair = 1.0 - xs @ xs.T
    ptab = pair.tolist()
    dl = dists.tolist()
    sel_rows: list[int] = []
    pruned_rows: list[int] = []
    for i in range(len(ids)):
        if len(sel_rows) >= max_m:
            break
        di = dl[i]
        row = ptab[i]
        ok = True
        for r in sel_rows:
            if row[r] <= di:
                ok = False
                break
        if ok:
            sel_rows.append(i)
        else:
            pruned_rows.append(i)
    if len(sel_rows) < max_m:  # keepPrunedConnections backfill
        sel_rows.extend(pruned_rows[: max_m - len(sel_rows)])
    sel = np.asarray(sel_rows, dtype=np.int64)
    return ids[sel], dists[sel]


def rng_prune_rows(
    store: VectorStore,
    ids: np.ndarray,
    dists: np.ndarray,
    max_m: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RNG prune of R independent candidate rows in one vectorised pass —
    the batch-construction twin of ``rng_prune`` (same greedy rule, same
    keepPrunedConnections backfill, same nearest-first order).

    ``ids`` [R, T] (-1 padded) with ``dists`` [R, T] (+inf padded).  All
    R pairwise matrices come from ONE batched matmul, and the greedy scan
    runs as T lock-step mask-algebra steps over every row simultaneously:
    candidate ``i`` is accepted iff it is not shadowed by an accepted
    ``s`` (``pair[i, s] <= dist[i]``) and the row still has slots.  A row
    whose greedy pass accepts fewer than ``max_m`` backfills with its
    nearest rejected candidates, exactly like the list API (the backfill
    can only matter when the slot gate never fired, so gate-blocked
    candidates are never wrongly backfilled).

    Returns ``(sel_ids, sel_d, sel_mask)`` of shape [R, max_m]: the
    selected ids per row in selection order, -1/inf padded, with the
    validity mask.
    """
    R, T = ids.shape
    ar = np.arange(R)[:, None]
    order = np.argsort(dists, axis=1, kind="stable")
    ids = ids[ar, order]
    dists = dists[ar, order]
    valid = (ids >= 0) & np.isfinite(dists)
    n_cand = valid.sum(axis=1)
    sel_ids = np.full((R, max_m), -1, dtype=ids.dtype)
    sel_d = np.full((R, max_m), np.inf, dtype=dists.dtype)
    # rows that already fit need no pruning (the list API's short-circuit):
    # their selection is just the first max_m sorted candidates
    hard = np.nonzero(n_cand > max_m)[0]
    triv = n_cand <= max_m
    if triv.any():
        w = min(max_m, T)
        sel_ids[triv, :w] = np.where(valid[triv, :w], ids[triv, :w], -1)
        sel_d[triv, :w] = np.where(valid[triv, :w], dists[triv, :w], np.inf)
    if hard.size:
        idh, dh, vh = ids[hard], dists[hard], valid[hard]
        Rh = len(hard)
        arh = np.arange(Rh)[:, None]
        xs = store.vectors[np.maximum(idh, 0)]  # [Rh, T, d]
        dots = np.matmul(xs, xs.transpose(0, 2, 1))
        if store.metric == "l2":
            sq = np.einsum("rtd,rtd->rt", xs, xs)
            pair = sq[:, :, None] + sq[:, None, :] - 2.0 * dots
        else:
            pair = 1.0 - dots
        acc = np.zeros((Rh, T), dtype=bool)
        cnt = np.zeros(Rh, dtype=np.int64)
        nch = n_cand[hard]
        for i in range(T):
            shadowed = ((pair[:, i, :] <= dh[:, i, None]) & acc).any(axis=1)
            ok = vh[:, i] & (cnt < max_m) & ~shadowed
            acc[:, i] = ok
            cnt += ok
            # early exit: once every row is full or out of candidates, the
            # remaining steps only produce rejections the backfill ignores
            if i + 1 < T and ((cnt >= max_m) | (nch <= i + 1)).all():
                break
        rank = np.arange(T)[None, :]
        key = np.where(acc, rank, T + rank)
        key = np.where(vh, key, 3 * T)
        order2 = np.argsort(key, axis=1, kind="stable")[:, :max_m]
        mk = key[arh, order2] < 3 * T
        sel_ids[hard] = np.where(mk, idh[arh, order2], -1)
        sel_d[hard] = np.where(mk, dh[arh, order2], np.inf)
    return sel_ids, sel_d, sel_ids >= 0
