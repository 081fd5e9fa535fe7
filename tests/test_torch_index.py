"""repro_torch host index vs the JAX package's: quantization, the WBT, the
built graphs (sequential and batched inserts, deletes and compaction),
host search, and snapshots (full and incremental).  The host index is
numpy in both packages, so everything here is held bitwise."""
import ml_dtypes
import numpy as np
import pytest

import repro.core as rc
from repro.core.snapshot import take_snapshot as ref_take_snapshot
from repro.core.store import quantize_rows as ref_quantize_rows
from repro_torch import core as tc
from repro_torch.core.search import search_candidates_batch
from repro_torch.core.snapshot import take_snapshot
from repro_torch.core.store import quantize_rows, vec_np_dtype

from _invariants import assert_graph_equal


def _awkward_rows(rng):
    """f32 rows that exercise rounding: bf16 round-half-to-even ties,
    subnormals, zeros, a lone huge value, and int8 half-way quotients."""
    rows = rng.normal(size=(64, 20)).astype(np.float32) * 3
    rows[0] = 0.0
    rows[1, :4] = [1 + 2.0**-8, 1 + 3 * 2.0**-8, -(1 + 2.0**-8), 2.0**-130]
    rows[2] = 1e30
    rows[2, 1:] = 1.0
    rows[3] = np.arange(20, dtype=np.float32) - 9.5  # int8 x.5 quotients
    rows[4] = 1e-40
    return rows


def test_quantize_rows_bitwise():
    """int8 slab + scales equal the reference's; bf16 uint16 bits equal
    ml_dtypes' rounding."""
    rows = _awkward_rows(np.random.default_rng(0))
    slab, scales = quantize_rows(rows, "int8")
    rslab, rscales = ref_quantize_rows(rows, "int8")
    np.testing.assert_array_equal(slab, rslab)
    np.testing.assert_array_equal(scales.view(np.uint32),
                                  rscales.view(np.uint32))
    bits, none = quantize_rows(rows, "bf16")
    rbits, _ = ref_quantize_rows(rows, "bf16")
    assert none is None and bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, rbits.view(np.uint16))
    np.testing.assert_array_equal(
        bits, rows.astype(ml_dtypes.bfloat16).view(np.uint16))
    f32, _ = quantize_rows(rows, "f32")
    np.testing.assert_array_equal(f32, rows)
    assert vec_np_dtype("bf16") == np.uint16
    with pytest.raises(ValueError):
        quantize_rows(rows, "fp8")


def test_wbt_operations_match():
    """Order statistics, windows and entry selection agree value for value
    with the reference WBT, duplicates included."""
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 300, size=500).astype(np.float64)
    a, b = tc.WBT(), rc.WBT()
    for v in vals:
        assert a.insert(v) == b.insert(v)
    a.check_invariants()
    np.testing.assert_array_equal(a.in_order(), b.in_order())
    for v in rng.uniform(-10, 310, size=60):
        assert a.rank(v) == b.rank(v)
        assert a.count_le(v) == b.count_le(v)
        assert a.contains(v) == b.contains(v)
        for half in (1, 4, 16, 64):
            assert a.window(v, half) == b.window(v, half)
        x, y = sorted(rng.uniform(-10, 310, size=2))
        assert a.count_range(x, y) == b.count_range(x, y)
        assert a.closest_in_range(v, x, y) == b.closest_in_range(v, x, y)
    for k in range(0, len(a), 7):
        assert a.select(k) == b.select(k)


@pytest.fixture(scope="module")
def workload():
    return tc.make_workload(n=1500, d=16, nq=24, seed=0, k=10)


@pytest.fixture(scope="module")
def batched_pair(workload):
    """Both packages' indexes after the same batched inserts."""
    kw = dict(dim=16, m=8, ef_construction=32, o=4, seed=0)
    a, b = tc.WoWIndex(**kw), rc.WoWIndex(**kw)
    a.insert_batch(workload.vectors, workload.attrs, batch_size=64)
    b.insert_batch(workload.vectors, workload.attrs, batch_size=64,
                   backend="numpy")
    return a, b


def test_workload_matches(workload):
    ref = rc.make_workload(n=1500, d=16, nq=24, seed=0, k=10)
    np.testing.assert_array_equal(workload.vectors, ref.vectors)
    np.testing.assert_array_equal(workload.ranges, ref.ranges)
    for g1, g2 in zip(workload.gt, ref.gt):
        np.testing.assert_array_equal(g1, g2)


def test_sequential_insert_graph_bitwise(workload):
    kw = dict(dim=16, m=8, ef_construction=24, o=4, seed=3)
    a, b = tc.WoWIndex(**kw), rc.WoWIndex(**kw)
    for v, x in zip(workload.vectors[:400], workload.attrs[:400]):
        assert a.insert(v, x) == b.insert(v, x)
    assert_graph_equal(a, b, "sequential")
    assert vars(a.build_stats) == vars(b.build_stats)


def test_batched_insert_graph_bitwise(batched_pair):
    a, b = batched_pair
    assert_graph_equal(a, b, "insert_batch(numpy)")
    assert vars(a.build_stats) == vars(b.build_stats)
    assert a.describe() == b.describe()


def test_host_search_matches(batched_pair, workload):
    a, b = batched_pair
    for q, r in zip(workload.queries, workload.ranges):
        ia, da, sa = a.search(q, tuple(r), k=10, ef=48)
        ib, db, sb = b.search(q, tuple(r), k=10, ef=48)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da, db)
        assert vars(sa) == vars(sb)


def _assert_snap_equal(s, r):
    for f in ("vectors", "sq_norms", "attrs", "neighbors", "uvals",
              "uval_rep", "ids_map"):
        np.testing.assert_array_equal(getattr(s, f), getattr(r, f), f)
    assert (s.m, s.o, s.metric, s.stamp) == (r.m, r.o, r.metric, r.stamp)


def test_snapshots_full_and_incremental(workload):
    """Full snapshot, then an ingest and an incremental refresh: equal to
    the reference's arrays, and the refresh equal to a full rebuild."""
    kw = dict(dim=16, m=8, ef_construction=32, o=4, seed=0)
    a, b = tc.WoWIndex(**kw), rc.WoWIndex(**kw)
    half = 900
    a.insert_batch(workload.vectors[:half], workload.attrs[:half])
    b.insert_batch(workload.vectors[:half], workload.attrs[:half])
    sa, sb = take_snapshot(a), ref_take_snapshot(b)
    _assert_snap_equal(sa, sb)
    a.insert_batch(workload.vectors[half:], workload.attrs[half:])
    b.insert_batch(workload.vectors[half:], workload.attrs[half:])
    ia, ib = take_snapshot(a, prev=sa), ref_take_snapshot(b, prev=sb)
    _assert_snap_equal(ia, ib)
    _assert_snap_equal(ia, take_snapshot(a))


def test_delete_and_compact_rows_bitwise(workload):
    kw = dict(dim=16, m=8, ef_construction=32, o=4, seed=0)
    a, b = tc.WoWIndex(**kw), rc.WoWIndex(**kw)
    a.insert_batch(workload.vectors[:800], workload.attrs[:800])
    b.insert_batch(workload.vectors[:800], workload.attrs[:800])
    for vid in range(0, 800, 9):
        a.delete(vid)
        b.delete(vid)
    a.undelete(9)
    b.undelete(9)
    assert a.compact_rows() == b.compact_rows()
    assert_graph_equal(a, b, "compact_rows")
    _assert_snap_equal(take_snapshot(a), ref_take_snapshot(b))
    assert a.selectivity(100.0, 400.0) == b.selectivity(100.0, 400.0)


def test_unported_build_backends_raise(workload):
    idx = tc.WoWIndex(dim=16, m=8, ef_construction=32, o=4, seed=0)
    for backend in ("ops", "device", "sharded", "bogus"):
        with pytest.raises(ValueError, match="registered backends: numpy"):
            idx.insert_batch(workload.vectors[:10], workload.attrs[:10],
                             backend=backend)
    idx.insert_batch(workload.vectors[:40], workload.attrs[:40])
    with pytest.raises(NotImplementedError, match="A5"):
        search_candidates_batch(
            idx.store, idx.graph, workload.vectors[:2], np.zeros(2),
            np.asarray([[0.0, 1e9], [0.0, 1e9]]), 0, idx.graph.top, 16,
            backend="ops")
