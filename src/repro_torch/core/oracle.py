"""Ground truth + oracle proximity graph for evaluation (§4.4, Fig. 5).

* ``brute_force`` — exact in-range k-NN (the paper's pre-filtering baseline
  doubles as the recall gold standard).
* ``FlatNSW`` — an incrementally built single-layer RNG-pruned proximity
  graph; with no range filter this is the paper's "HNSW-L0" reference build,
  and built over exactly the in-range subset of a query range it is the
  *oracle proximity graph* whose DC-recall curve lower-bounds every RFANNS
  index (Fig. 5).  It reuses WoW's own search/prune machinery (a window graph
  with a single all-covering window), so DC accounting is identical.
"""
from __future__ import annotations

import numpy as np

from .graph import LayeredGraph
from .search import _Visited, rng_prune, search_candidates
from .store import SearchStats, VectorStore

_INF_RANGE = (-np.inf, np.inf)


def brute_force(
    vectors: np.ndarray,
    attrs: np.ndarray,
    q: np.ndarray,
    rng: tuple[float, float],
    k: int,
    metric: str = "l2",
) -> np.ndarray:
    """Exact in-range k nearest (vertex ids into ``vectors``)."""
    mask = (attrs >= rng[0]) & (attrs <= rng[1])
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return np.empty(0, dtype=np.int64)
    x = vectors[idx]
    if metric == "l2":
        d = ((x - q[None, :]) ** 2).sum(axis=1)
    else:
        d = 1.0 - x @ q
    order = np.argsort(d, kind="stable")[:k]
    return idx[order].astype(np.int64)


class FlatNSW:
    """Single-layer incremental RNG graph (window = entire dataset)."""

    def __init__(
        self,
        dim: int,
        m: int = 16,
        ef_construction: int = 128,
        metric: str = "l2",
        seed: int = 0,
    ):
        self.m = m
        self.ef_construction = ef_construction
        self.store = VectorStore(dim, metric=metric)
        self.graph = LayeredGraph(m)
        self._visited = _Visited()
        self._rng = np.random.default_rng(seed)
        self.build_dc = 0

    def __len__(self) -> int:
        return self.store.n

    def insert(self, vec: np.ndarray, attr: float = 0.0) -> int:
        vid = self.store.append(vec, attr)
        self.graph.ensure_capacity(self.store.n)
        if self.store.n == 1:
            return vid
        v = self.store.vectors[vid]
        ep = int(self._rng.integers(0, self.store.n - 1))
        stats = SearchStats()
        found = search_candidates(
            self.store, self.graph, self._visited, ep, v, _INF_RANGE,
            l_min=0, l_max=0, width=self.ef_construction, stats=stats, exclude=vid,
        )
        self.build_dc += stats.dc
        sel = rng_prune(self.store, v, found, max(1, self.m // 2))
        self.graph.set_neighbors(0, vid, np.asarray([j for _, j in sel], dtype=np.int32))
        for d_ab, b in sel:
            if self.graph.append_neighbor(0, b, vid):
                continue
            vb = self.store.vectors[b]
            keep = [int(j) for j in self.graph.neighbors(0, b)]
            cand = [(d_ab, vid)]
            if keep:
                ids = np.asarray(keep, dtype=np.int64)
                dd = self.store.dist_batch(vb, ids)
                self.build_dc += len(keep)
                cand.extend(zip(dd.tolist(), keep))
            kept = rng_prune(self.store, vb, cand, self.m)
            self.graph.set_neighbors(0, b, np.asarray([j for _, j in kept], dtype=np.int32))
        return vid

    def search(
        self,
        q: np.ndarray,
        k: int = 10,
        ef: int = 64,
        rng: tuple[float, float] = _INF_RANGE,
        stats: SearchStats | None = None,
    ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Beam search; pass ``rng`` to run in-filtering on this flat graph
        (the single-graph baseline; with the default range it is plain ANNS).
        """
        if stats is None:
            stats = SearchStats()
        if self.store.n == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32), stats
        q = self.store.prepare(np.asarray(q))
        if np.isfinite(rng[0]) or np.isfinite(rng[1]):
            mask = (self.store.attrs[: self.store.n] >= rng[0]) & (
                self.store.attrs[: self.store.n] <= rng[1]
            )
            in_ids = np.nonzero(mask)[0]
            if in_ids.size == 0:
                return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32), stats
            ep = int(in_ids[self._rng.integers(0, in_ids.size)])
        else:
            ep = int(self._rng.integers(0, self.store.n))
        found = search_candidates(
            self.store, self.graph, self._visited, ep, q, rng,
            l_min=0, l_max=0, width=max(ef, k), stats=stats,
        )
        found = found[:k]
        ids = np.asarray([j for _, j in found], dtype=np.int64)
        return ids, np.asarray([d for d, _ in found], dtype=np.float32), stats


def build_oracle_graph(
    vectors: np.ndarray,
    attrs: np.ndarray,
    rng: tuple[float, float],
    m: int,
    ef_construction: int,
    metric: str = "l2",
    seed: int = 0,
) -> tuple[FlatNSW, np.ndarray]:
    """Oracle proximity graph over exactly the in-range subset (Fig. 1a).

    Returns the graph plus the mapping local-id -> global-id.
    """
    mask = (attrs >= rng[0]) & (attrs <= rng[1])
    ids = np.nonzero(mask)[0]
    g = FlatNSW(vectors.shape[1], m=m, ef_construction=ef_construction, metric=metric, seed=seed)
    for gid in ids:
        g.insert(vectors[gid], float(attrs[gid]))
    return g, ids.astype(np.int64)
