"""The paper's baselines in the port (``repro_torch.core.baselines``:
``PreFiltering``, ``PostFiltering``, ``SingleGraphInFilter``) against the
JAX package's on the same inputs and seed: equal ids and ``SearchStats``
for every query.  And the quality ordering of ``tests/test_system.py``
and ``tests/test_sharding_distributed.py`` against the port's
``WoWIndex``."""
import dataclasses

import numpy as np
import pytest

import repro.core as rc
from repro_torch import core as tc

BASELINES = ("PreFiltering", "PostFiltering", "SingleGraphInFilter")


@pytest.fixture(scope="module")
def wl():
    return rc.make_workload(n=800, d=16, nq=24, seed=0, k=10)


def _make(pkg, name, wl):
    cls = getattr(pkg, name)
    if name == "PreFiltering":
        return cls(wl.vectors, wl.attrs)
    return cls(wl.vectors, wl.attrs, m=12, ef_construction=48, seed=0)


def _search(base, name, q, r):
    if name == "PreFiltering":
        return base.search(q, r, k=10)
    return base.search(q, r, k=10, ef=32)


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_jax(wl, name):
    got, exp = _make(tc, name, wl), _make(rc, name, wl)
    for i in range(len(wl.queries)):
        r = tuple(wl.ranges[i])
        ids_t, st_t = _search(got, name, wl.queries[i], r)
        ids_j, st_j = _search(exp, name, wl.queries[i], r)
        np.testing.assert_array_equal(ids_t, ids_j)
        assert dataclasses.asdict(st_t) == dataclasses.asdict(st_j), i


def test_baselines_recall(wl):
    """Pre-filtering is exact; post-filtering keeps recall@10 >= 0.7."""
    pre = tc.PreFiltering(wl.vectors, wl.attrs)
    post = tc.PostFiltering(wl.vectors, wl.attrs, m=12, ef_construction=48,
                            seed=0)
    recs_pre, recs_post = [], []
    for i in range(12):
        r = tuple(wl.ranges[i])
        ids, _ = pre.search(wl.queries[i], r, k=10)
        recs_pre.append(tc.recall(ids, wl.gt[i]))
        ids, _ = post.search(wl.queries[i], r, k=10, ef=64)
        recs_post.append(tc.recall(ids, wl.gt[i]))
    assert np.mean(recs_pre) == 1.0
    assert np.mean(recs_post) >= 0.7


def test_wow_beats_single_graph_on_selective_filters():
    """The paper's core claim vs flat in-filtering, on the port: under a
    selective filter (2^-6 of the data in range) one proximity graph loses
    frontier connectivity; WoW keeps recall."""
    wl = tc.make_workload(n=1500, d=16, nq=30, fractions=[2**-6], seed=7,
                          k=10)
    wow = tc.WoWIndex(dim=16, m=12, ef_construction=48, o=4, seed=0)
    for v, a in zip(wl.vectors, wl.attrs):
        wow.insert(v, a)
    flat = tc.SingleGraphInFilter(wl.vectors, wl.attrs, m=12,
                                  ef_construction=48, seed=0)
    r_wow, r_flat = [], []
    for i in range(len(wl.queries)):
        r = tuple(wl.ranges[i])
        ids, _, _ = wow.search(wl.queries[i], r, k=10, ef=64)
        r_wow.append(tc.recall(ids, wl.gt[i]))
        ids2, _ = flat.search(wl.queries[i], r, k=10, ef=64)
        r_flat.append(tc.recall(ids2, wl.gt[i]))
    assert np.mean(r_wow) >= 0.95
    assert np.mean(r_wow) >= np.mean(r_flat) + 0.05, (np.mean(r_wow),
                                                      np.mean(r_flat))
