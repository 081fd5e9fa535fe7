"""The frozen generators: the base rows are fixed by the configuration's
``data_seed``; a run's seed gives the same queries and ingest rows each
time, and another seed other values of the same shapes (CPU)."""
import numpy as np
import pytest
import torch

from wowbench import data

SEEDS = [0, 7, 2**31 + 12345]
FR = data.mixed_fractions(-10, 0)


def draw(seed, n=256, d=16, data_seed=1):
    base = data.make_base(n, d, data_seed, "cpu")
    g = data.generator(seed, "cpu")
    new = data.make_ingest(base, 128, g)
    q = data.make_queries(base, 64, FR, g, fresh_every=4,
                          fresh_attrs=new.attrs)
    return {"base_vectors": base.vectors, "base_attrs": base.attrs,
            "pool_queries": q.vectors, "pool_ranges": q.ranges,
            "ingest_vectors": new.vectors, "ingest_attrs": new.attrs}


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_data(seed):
    a, b = draw(seed), draw(seed)
    for f in a:
        torch.testing.assert_close(a[f], b[f], rtol=0, atol=0)


def test_seeds_change_values_not_sizes():
    a, b = draw(SEEDS[0]), draw(SEEDS[2])
    for f in ("pool_queries", "ingest_vectors", "pool_ranges"):
        assert a[f].shape == b[f].shape
        assert not torch.equal(a[f], b[f])
    # the base is the configuration's, whatever the run's seed
    assert torch.equal(a["base_vectors"], b["base_vectors"])
    assert not torch.equal(draw(0, data_seed=2)["base_vectors"],
                           a["base_vectors"])
    # the ranges' in-range fractions are the mix's, whatever the seed:
    # over the base for three queries in four, over the ingested rows
    # for every fourth
    for d in (a, b):
        attrs = d["base_attrs"].numpy()
        new = d["ingest_attrs"].numpy()
        for i, (lo, hi) in enumerate(d["pool_ranges"].numpy()):
            fresh = i % 4 == 3
            pool = new if fresh else attrs
            n_in = ((pool >= lo) & (pool <= hi)).sum()
            j = i // 4 if fresh else i  # the fresh draws' own counter
            f = FR[j % len(FR)] if fresh else FR[i % len(FR)]
            assert n_in == max(1, int(np.floor(len(pool) * f)))


def test_attributes_and_dtypes():
    d = draw(3, n=200, d=8)
    assert d["base_vectors"].dtype == torch.float32
    assert d["pool_queries"].dtype == torch.float32
    assert d["pool_ranges"].dtype == torch.float64
    assert sorted(d["base_attrs"].tolist()) == list(range(200))
    assert d["ingest_attrs"].tolist() == list(range(200, 328))
    assert d["ingest_vectors"].shape == (128, 8)


def test_mixed_fractions():
    assert data.mixed_fractions(-10, 0) == [2.0**e for e in range(-10, 1)]
