"""The benchmark's data: the base rows of a configuration, and the queries,
ranges and ingest rows of a run.

The base rows are a fixed data set, as SIFT1M or GIST1M are: clustered
vectors and a permutation of their row numbers as attributes (the paper's
random regime), drawn from the configuration's own ``data_seed`` and the
same in every run, so that the index built over them can be kept in the
checkout (``index_cache``).  What a run sends is drawn from ``--seed``: its
queries (base rows plus noise), their ranges at the mix's in-range
fractions, and the rows it ingests (from the base's clusters, with
attributes that continue past the base's in arrival order, as timestamps
do).  Every seed gives arrays of the same shapes; the seed changes the
values, never the sizes.

Everything is drawn on ``device`` with a ``torch.Generator`` there, in a
few large calls.  The generators follow ``make_vectors``, ``make_attrs``
and ``make_ranges`` of ``repro_torch/core/datasets.py`` and the query tail
of its ``_assemble_workload``, frozen here so that a later change to the
program cannot move the yardstick.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

CLUSTERS = 32
QUERY_NOISE = 0.25


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % 2**63)
    return g


@dataclass
class Base:
    """A configuration's base rows, on the device."""

    vectors: torch.Tensor  # f32[n, d]
    attrs: torch.Tensor  # f64[n], a permutation of 0 .. n-1
    centers: torch.Tensor  # f32[CLUSTERS, d]


def make_base(n: int, d: int, data_seed: int, device) -> Base:
    """``n`` clustered rows of width ``d`` (centers N(0, 16), rows N(center,
    1)) and their permutation attributes."""
    g = generator(data_seed, device)
    dev = torch.device(device)
    centers = torch.randn(CLUSTERS, d, generator=g, device=dev) * 4.0
    assign = torch.randint(0, CLUSTERS, (n,), generator=g, device=dev)
    x = centers[assign]
    x += torch.randn(n, d, generator=g, device=dev)
    attrs = torch.randperm(n, generator=g, device=dev).double()
    return Base(x, attrs, centers)


def mixed_fractions(lo_log2: int, hi_log2: int) -> list[float]:
    """The paper's mixed workload: in-range fractions 2^lo .. 2^hi in
    equal parts."""
    return [2.0**e for e in range(lo_log2, hi_log2 + 1)]


def make_ranges(sorted_attrs: torch.Tensor, nq: int, fractions,
                g: torch.Generator) -> torch.Tensor:
    """``nq`` ranges over ``sorted_attrs``, query ``i`` holding
    ``max(1, floor(n * fractions[i % len]))`` of them at a random start
    -> f64[nq, 2] of (lo, hi)."""
    dev = sorted_attrs.device
    n = len(sorted_attrs)
    fr = torch.as_tensor(fractions, dtype=torch.float64, device=dev)
    f = fr[torch.arange(nq, device=dev) % len(fr)]
    n_in = torch.clamp(torch.floor(n * f), min=1).long()
    u = torch.rand(nq, generator=g, device=dev, dtype=torch.float64)
    start = torch.floor(u * (n - n_in + 1)).long()
    return torch.stack([sorted_attrs[start], sorted_attrs[start + n_in - 1]],
                       1)


@dataclass
class Queries:
    """A run's query pool."""

    vectors: torch.Tensor  # f32[P, d]
    ranges: torch.Tensor  # f64[P, 2]


def make_queries(base: Base, nq: int, fractions, g: torch.Generator,
                 fresh_every: int = 0, fresh_attrs=None) -> Queries:
    """``nq`` queries near random base rows (noise ``QUERY_NOISE``) with
    ranges at the mixed ``fractions`` over the base's attributes; with
    ``fresh_every`` k, every k-th query's range lies over ``fresh_attrs``
    (sorted) instead: the rows ingested after the base."""
    dev = base.vectors.device
    rows = torch.randint(0, len(base.vectors), (nq,), generator=g, device=dev)
    q = base.vectors[rows]
    q = q + QUERY_NOISE * torch.randn(q.shape, generator=g, device=dev)
    ranges = make_ranges(torch.sort(base.attrs).values, nq, fractions, g)
    if fresh_every:
        pick = torch.arange(fresh_every - 1, nq, fresh_every, device=dev)
        ranges[pick] = make_ranges(fresh_attrs.to(dev), len(pick),
                                   fractions, g)
    return Queries(q, ranges)


@dataclass
class Ingest:
    """A run's ingest rows, in the order they are sent."""

    vectors: torch.Tensor  # f32[I, d]
    attrs: torch.Tensor  # f64[I]: n, n + 1, ... (arrival order)


def make_ingest(base: Base, rows: int, g: torch.Generator) -> Ingest:
    """``rows`` new rows from the base's clusters, attributes ``n + i``."""
    dev = base.vectors.device
    assign = torch.randint(0, CLUSTERS, (rows,), generator=g, device=dev)
    x = base.centers[assign]
    x += torch.randn(rows, x.shape[1], generator=g, device=dev)
    n = len(base.attrs)
    attrs = torch.arange(n, n + rows, device=dev, dtype=torch.float64)
    return Ingest(x, attrs)
