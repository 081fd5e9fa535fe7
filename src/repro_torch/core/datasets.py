"""Synthetic RFANNS workloads (offline stand-ins for Sift/Gist/ArXiv/...).

The paper's datasets are not available offline; these generators reproduce
the *structural* properties the experiments stress:

  * clustered vector distributions (graph hardness; cf. LID discussion §4.1),
  * attribute/vector correlation regimes (Fig. 8): ``random`` (no
    correlation), ``correlated`` (attribute follows a vector projection —
    nearest vectors tend to pass the filter), ``anticorrelated`` (nearest
    vectors tend to fail it),
  * query ranges generated by in-range fraction f = 2^-10 .. 2^0 (Def. 3),
  * duplicate-attribute workloads (Fig. 12) via a bounded unique-value count.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Workload:
    vectors: np.ndarray  # (n, d) float32
    attrs: np.ndarray  # (n,) float64
    queries: np.ndarray  # (nq, d) float32
    ranges: np.ndarray  # (nq, 2) float64
    fractions: np.ndarray  # (nq,) in-range fraction per query
    gt: list[np.ndarray] | None = None  # ground-truth ids per query


def make_vectors(n: int, d: int, seed: int = 0, clusters: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, size=n)
    x = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


def make_attrs(
    vectors: np.ndarray,
    kind: str = "random",
    seed: int = 0,
    n_unique: int | None = None,
) -> np.ndarray:
    n, d = vectors.shape
    rng = np.random.default_rng(seed + 1)
    if kind == "random":
        a = rng.permutation(n).astype(np.float64)
    elif kind == "correlated":
        proj = vectors @ rng.normal(size=(d,))
        noise = rng.normal(scale=0.05 * proj.std(), size=n)
        a = np.argsort(np.argsort(proj + noise)).astype(np.float64)
    elif kind == "anticorrelated":
        proj = vectors @ rng.normal(size=(d,))
        # attribute rank is distance from the projection median: near vectors
        # in projection space land at opposite attribute extremes.
        med = np.median(proj)
        a = np.argsort(np.argsort(np.abs(proj - med))).astype(np.float64)
    else:
        raise ValueError(f"unknown attr kind {kind!r}")
    if n_unique is not None and n_unique < n:
        a = np.floor(a * (n_unique / n))
    return a


def make_ranges(
    attrs: np.ndarray,
    nq: int,
    fractions: list[float] | np.ndarray,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Random ranges with the given in-range fractions (round-robin)."""
    rng = np.random.default_rng(seed + 2)
    n = len(attrs)
    sorted_a = np.sort(attrs)
    ranges = np.empty((nq, 2), dtype=np.float64)
    fr = np.empty(nq, dtype=np.float64)
    fracs = np.asarray(fractions, dtype=np.float64)
    for i in range(nq):
        f = float(fracs[i % len(fracs)])
        n_in = max(1, int(np.floor(n * f)))
        start = int(rng.integers(0, n - n_in + 1))
        ranges[i, 0] = sorted_a[start]
        ranges[i, 1] = sorted_a[start + n_in - 1]
        fr[i] = f
    return ranges, fr


def _assemble_workload(
    vectors: np.ndarray,
    attrs: np.ndarray,
    nq: int,
    fractions: list[float] | None,
    seed: int,
    k: int,
    with_gt: bool,
    metric: str,
) -> Workload:
    """Shared query/range/ground-truth tail of every workload factory (one
    implementation, so ``make_regime_workload('random', ...)`` stays bit
    for bit ``make_workload(...)``)."""
    if fractions is None:
        # the paper's "mixed" workload: equal parts 2^-10 .. 2^0
        fractions = [2.0**-e for e in range(10, -1, -1)]
    n = len(vectors)
    attrs = np.asarray(attrs, np.float64)
    rng = np.random.default_rng(seed + 3)
    base = vectors[rng.integers(0, n, size=nq)]
    queries = (base + rng.normal(scale=0.25, size=base.shape)).astype(np.float32)
    ranges, fr = make_ranges(attrs, nq, fractions, seed=seed)
    gt = None
    if with_gt:
        from .oracle import brute_force

        vecs = vectors
        if metric == "cosine":
            vecs = vectors / np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)
        gt = [
            brute_force(vecs, attrs, _prep(queries[i], metric), tuple(ranges[i]), k, metric)
            for i in range(nq)
        ]
    return Workload(vectors, attrs, queries, ranges, fr, gt)


def make_workload(
    n: int = 4000,
    d: int = 32,
    nq: int = 100,
    fractions: list[float] | None = None,
    attr_kind: str = "random",
    seed: int = 0,
    n_unique: int | None = None,
    with_gt: bool = True,
    k: int = 10,
    metric: str = "l2",
) -> Workload:
    vectors = make_vectors(n, d, seed=seed)
    attrs = make_attrs(vectors, kind=attr_kind, seed=seed, n_unique=n_unique)
    return _assemble_workload(vectors, attrs, nq, fractions, seed, k,
                              with_gt, metric)


#: named attribute/workload regimes (Fig. 8 correlation regimes + the
#: structural stress cases every batched builder must survive) — one
#: registry shared by the build-equivalence harness
#: (``tests/test_build_equivalence.py`` via ``tests/_workloads.py``) and
#: ``benchmarks/bench_build.py --regime``.
REGIMES = {
    "random": "uncorrelated permutation-rank attributes",
    "correlated": "attribute follows a vector projection (Fig. 8)",
    "anticorrelated": "near vectors at opposite attribute extremes (Fig. 8)",
    "clustered": "attribute values clumped around a few centers",
    "duplicate_heavy": "~n/20 unique attribute values (Fig. 12)",
    "adversarial_sorted": "insertion stream in ascending attribute order",
}


def regime_attrs(
    vectors: np.ndarray, regime: str, seed: int = 0
) -> tuple[np.ndarray, np.ndarray | None]:
    """Attributes for a named regime -> (attrs, stream_order or None).
    ``stream_order`` permutes the insertion stream (only
    ``adversarial_sorted`` uses it — ascending attribute order, the worst
    case for incremental window maintenance: every insert lands at the
    moving frontier of the value set)."""
    n = len(vectors)
    rng = np.random.default_rng(seed + 7)
    if regime in ("random", "correlated", "anticorrelated"):
        return make_attrs(vectors, kind=regime, seed=seed), None
    if regime == "clustered":
        centers = np.sort(rng.uniform(0.0, float(n), size=max(4, n // 100)))
        assign = rng.integers(0, len(centers), size=n)
        return centers[assign] + rng.normal(scale=0.5, size=n), None
    if regime == "duplicate_heavy":
        return (
            make_attrs(vectors, kind="random", seed=seed,
                       n_unique=max(8, n // 20)),
            None,
        )
    if regime == "adversarial_sorted":
        attrs = make_attrs(vectors, kind="random", seed=seed)
        return attrs, np.argsort(attrs, kind="stable")
    raise ValueError(
        f"unknown workload regime {regime!r}; registered regimes: "
        f"{', '.join(sorted(REGIMES))}"
    )


def make_regime_workload(
    regime: str,
    n: int = 400,
    d: int = 12,
    nq: int = 16,
    seed: int = 0,
    k: int = 10,
    with_gt: bool = True,
    fractions: list[float] | None = None,
) -> Workload:
    """Standard ``Workload`` under a named regime (see ``REGIMES``); ground
    truth is computed AFTER any stream reordering, so ids always refer to
    insertion order.  ``regime="random"`` reproduces ``make_workload``'s
    arrays bit for bit (both share ``_assemble_workload``)."""
    vectors = make_vectors(n, d, seed=seed)
    attrs, order = regime_attrs(vectors, regime, seed=seed)
    if order is not None:  # reorder the insertion stream, ids follow
        vectors = vectors[order]
        attrs = attrs[order]
    return _assemble_workload(vectors, attrs, nq, fractions, seed, k,
                              with_gt, "l2")


def _prep(q: np.ndarray, metric: str) -> np.ndarray:
    if metric == "cosine":
        return (q / max(float(np.linalg.norm(q)), 1e-12)).astype(np.float32)
    return q.astype(np.float32)


def recall(found: np.ndarray, gold: np.ndarray) -> float:
    """Recall@k; uses |gold| as the denominator when n' < k (Def. 2 note)."""
    if len(gold) == 0:
        return 1.0
    return len(np.intersect1d(found, gold)) / len(gold)
