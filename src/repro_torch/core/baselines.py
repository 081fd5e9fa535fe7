"""RFANNS baselines the paper compares against (§2.2, Table 2).

* ``PreFiltering``  — select in-range vectors, linear scan (exact; DC = n').
* ``PostFiltering`` — plain ANNS graph over everything; retrieve s*k
  intermediates, drop out-of-range, retry with a doubled beam until k
  in-range results are found (the paper's post-filtering protocol).
* ``SingleGraphInFilter`` — in-filtering beam search on one flat proximity
  graph (an ACORN-1-style predicate-agnostic baseline: only in-range vertices
  are distance-evaluated, but there is no hierarchy to keep the frontier
  connected under selective filters).
"""
from __future__ import annotations

import numpy as np

from .oracle import FlatNSW, brute_force
from .store import SearchStats


class PreFiltering:
    def __init__(self, vectors: np.ndarray, attrs: np.ndarray, metric: str = "l2"):
        self.vectors = np.asarray(vectors, dtype=np.float32)
        if metric == "cosine":
            nrm = np.linalg.norm(self.vectors, axis=1, keepdims=True)
            self.vectors = self.vectors / np.maximum(nrm, 1e-12)
        self.attrs = np.asarray(attrs, dtype=np.float64)
        self.metric = metric

    def search(self, q, rng, k=10, stats: SearchStats | None = None):
        if stats is None:
            stats = SearchStats()
        mask = (self.attrs >= rng[0]) & (self.attrs <= rng[1])
        stats.filter_checks += len(self.attrs)
        stats.dc += int(mask.sum())
        ids = brute_force(self.vectors, self.attrs, np.asarray(q, np.float32), rng, k, self.metric)
        return ids, stats


class PostFiltering:
    def __init__(self, vectors, attrs, m=16, ef_construction=128, metric="l2", seed=0):
        self.attrs = np.asarray(attrs, dtype=np.float64)
        self.graph = FlatNSW(vectors.shape[1], m=m, ef_construction=ef_construction,
                             metric=metric, seed=seed)
        for v, a in zip(vectors, self.attrs):
            self.graph.insert(v, float(a))

    def search(self, q, rng, k=10, ef=64, max_rounds=6, stats: SearchStats | None = None):
        if stats is None:
            stats = SearchStats()
        n = len(self.graph)
        n_prime = int(((self.attrs >= rng[0]) & (self.attrs <= rng[1])).sum())
        if n_prime == 0:
            return np.empty(0, dtype=np.int64), stats
        sel = n / max(n_prime, 1)  # selectivity s = 1/f (Def. 3)
        width = max(ef, int(np.ceil(sel * k)))
        for _ in range(max_rounds):
            ids, _, st = self.graph.search(q, k=width, ef=width, stats=SearchStats())
            stats.merge(st)
            stats.filter_checks += len(ids)
            good = ids[(self.attrs[ids] >= rng[0]) & (self.attrs[ids] <= rng[1])]
            if len(good) >= min(k, n_prime) or width >= n:
                return good[:k], stats
            width *= 2
        return good[:k], stats


class SingleGraphInFilter:
    def __init__(self, vectors, attrs, m=16, ef_construction=128, metric="l2", seed=0):
        self.graph = FlatNSW(vectors.shape[1], m=m, ef_construction=ef_construction,
                             metric=metric, seed=seed)
        for v, a in zip(vectors, attrs):
            self.graph.insert(v, float(a))

    def search(self, q, rng, k=10, ef=64, stats: SearchStats | None = None):
        if stats is None:
            stats = SearchStats()
        ids, _, st = self.graph.search(q, k=k, ef=ef, rng=(float(rng[0]), float(rng[1])))
        stats.merge(st)
        return ids, stats
