"""repro_torch serving hop loop vs ``repro.core.device_search``.

Stage level: the same integer inputs through each stage of the hop
(hashing, visited test/mark, dedupe, admission, counting merge, landing and
entry, padding) give bitwise the same integers in both packages; whole
hops are compared state field by state field.

End to end: ``search_batch`` in both packages on the same snapshot, for
visited {bitmap, hash} x compact {None, (8, 8)} x vec_dtype {f32, int8,
bf16}, served from a reference-built snapshot (carried over with
``from_reference``) and from a port-built one.  The rule
(``compare_results``): ids, dc and hops equal per query and dists within
1e-5 of the distance's term magnitude; a query may differ only as a tie
flip (equal distances at the first differing slot), on at most 2% of the
queries.  JAX runs its jnp reference of the gather kernel here (the Pallas
kernel is held against the same oracle in ``test_torch_kernels``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.core as rc
from repro.core import device_search as rds
from repro.core.search import hash_positions_np
from repro.core.snapshot import take_snapshot as ref_take_snapshot
from repro_torch import core as tc
from repro_torch.core import device_search as tds
from repro_torch.core.snapshot import take_snapshot

_BIG = 2**30
CPU = "cpu"


def _u32(t):
    """Port int64 words -> the uint32 bit pattern JAX holds."""
    return t.numpy().astype(np.uint32)


# ------------------------------------------------------------- stage level
@pytest.mark.parametrize("nh", [2, 3])
def test_hash_wordmask_bitwise(nh):
    rng = np.random.default_rng(nh)
    ids = np.concatenate([
        rng.integers(0, 2**31 - 1, size=200), [0, 1, 2**31 - 1, -1, -7],
    ]).astype(np.int32).reshape(5, -1)
    v_words = 2048
    w, m = tds._hash_wordmask(torch.from_numpy(ids), v_words, nh)
    jw, jm = rds._hash_wordmask(jnp.asarray(ids), v_words, nh)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(_u32(m), np.asarray(jm))
    pos = hash_positions_np(ids, v_words * 32, nh)  # the numpy twin
    np.testing.assert_array_equal(w.numpy(), pos[..., 0] // 32)
    bits = np.zeros(ids.shape, np.uint64)
    for i in range(nh):
        bits |= np.uint64(1) << (pos[..., i] % 32).astype(np.uint64)
    np.testing.assert_array_equal(m.numpy().astype(np.uint64), bits)


def _cfgs(visited):
    kw = dict(k=10, width=32, m=8, visited=visited, visited_bits=2**12)
    return tds.hop_cfg(**kw), rds.hop_cfg(**kw)


@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_visited_test_and_mark_bitwise(visited):
    rng = np.random.default_rng(7)
    B, K, n = 6, 9, 1000
    tcfg, jcfg = _cfgs(visited)
    words = (n + 31) // 32 if visited == "bitmap" else tcfg.v_words
    vstate = rng.integers(0, 2**32, size=(B, words + 1), dtype=np.uint64)
    vstate[:, -1] = 0  # the trash word
    vstate = vstate.astype(np.uint32)
    ids = rng.integers(0, n, size=(B, 3, 8)).astype(np.int32)
    valid = rng.random((B, 3, 8)) < 0.8
    tv = torch.from_numpy(vstate.astype(np.int64))
    got, cache = tds._visited_test_cached(tv, torch.from_numpy(ids),
                                          torch.from_numpy(valid), tcfg)
    exp, jcache = rds._visited_test_cached(jnp.asarray(vstate),
                                           jnp.asarray(ids),
                                           jnp.asarray(valid), jcfg)
    np.testing.assert_array_equal(got.numpy() & valid, np.asarray(exp) & valid)
    # mark distinct ids per row (post-dedupe), unvisited for the bitmap
    # (its add == OR only for unset bits, in both packages)
    sel = np.zeros((B, K), np.int32)
    for b in range(B):
        if visited == "bitmap":
            unset = [i for i in rng.permutation(n)
                     if not (vstate[b, i >> 5] >> (i & 31)) & 1]
            sel[b] = unset[:K]
        else:
            sel[b] = rng.permutation(n)[:K]
    sel_valid = rng.random((B, K)) < 0.7
    out = tds._visited_mark(tv.clone(), torch.from_numpy(sel),
                            torch.from_numpy(sel_valid), tcfg)
    jout = rds._visited_mark(jnp.asarray(vstate), jnp.asarray(sel),
                             jnp.asarray(sel_valid), jcfg)
    np.testing.assert_array_equal(_u32(out), np.asarray(jout))
    if visited == "hash":  # the cached-probe mark the hop body uses
        w, m = (c.reshape(B, -1)[:, :K] for c in cache)
        jw, jm = (c.reshape(B, -1)[:, :K] for c in jcache)
        out = tds._visited_mark_hash(tv.clone(), w, m,
                                     torch.from_numpy(sel_valid))
        jout = rds._visited_mark_hash(jnp.asarray(vstate), jw, jm,
                                      jnp.asarray(sel_valid))
        np.testing.assert_array_equal(_u32(out), np.asarray(jout))


def _dedupe_inputs(seed, B=5, F=48):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, size=(B, F)).astype(np.int32)  # heavy dups
    rank = np.stack([rng.permutation(F) for _ in range(B)]).astype(np.int32)
    rank[rng.random((B, F)) < 0.4] = _BIG  # ineligible slots
    return ids, rank


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedupe_and_admission_bitwise(seed):
    """One int64-key path == both JAX branches (packed uint32 keys, and the
    two-key lexsort it takes once n*(F+1) >= 2^32); then the packed
    admission sort picks the same K lanes."""
    ids, rank = _dedupe_inputs(seed)
    F, K = ids.shape[1], 9
    sid, srank = tds._dedupe_sorted(torch.from_numpy(ids).long(),
                                    torch.from_numpy(rank).long(), F)
    for n in (12, 2**28):
        jsid, jsrank = rds._dedupe_sorted(jnp.asarray(ids), jnp.asarray(rank),
                                          n, F)
        np.testing.assert_array_equal(sid.numpy(), np.asarray(jsid))
        np.testing.assert_array_equal(srank.numpy(), np.asarray(jsrank))
    sel_ids, sel_rank, sel_valid = tds._admit(sid, srank, F, K)
    # JAX's admission, as in _hop_body's fused branch
    posF = jnp.arange(F, dtype=jnp.uint32)[None, :]
    key2 = jnp.minimum(jnp.asarray(jsrank), F).astype(jnp.uint32) * (F + 1)
    key2 = lax.sort(key2 + posF, dimension=1)[:, :K]
    jrank = (key2 // (F + 1)).astype(jnp.int32)
    jpos = (key2 % (F + 1)).astype(jnp.int32)
    jvalid = jrank < F
    jids = jnp.where(jvalid, jnp.take_along_axis(jsid, jpos, axis=1), 0)
    np.testing.assert_array_equal(sel_rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(sel_valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(sel_ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("method", ["sort", "scatter", "onehot"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_counting_merge_bitwise(seed, method):
    """Ties, +inf padding and invalid entries merge identically."""
    rng = np.random.default_rng(seed)
    B, W, K = 4, 24, 9
    res_d = np.sort(rng.integers(0, 12, size=(B, W)).astype(np.float32), 1)
    for b in range(B):
        pad = rng.integers(0, W // 2)
        if pad:
            res_d[b, -pad:] = np.inf
    res_i = rng.integers(0, 1000, size=(B, W)).astype(np.int32)
    res_i[np.isinf(res_d)] = -1
    res_e = rng.random((B, W)) < 0.5
    res_e[np.isinf(res_d)] = True
    dd = rng.integers(0, 12, size=(B, K)).astype(np.float32)
    nv = rng.random((B, K)) < 0.7
    dd[~nv] = np.inf
    new_i = np.where(nv, rng.integers(0, 1000, size=(B, K)), -1).astype(
        np.int32)
    arrs = (res_d, res_i, res_e, dd, new_i, ~nv)
    got = tds._merge_sorted(*(torch.from_numpy(a) for a in arrs), W,
                            method=method)
    exp = rds._merge_sorted(*(jnp.asarray(a) for a in arrs), W,
                            method=method)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_argmin_returns_first_tie():
    """The hop pops with argmin; ties (and an all-+inf row) must pick the
    first index, as jnp.argmin does."""
    x = torch.tensor([[3.0, 1.0, 0.5, 0.5, 9.0], [np.inf] * 5])
    assert torch.argmin(x, dim=1).tolist() == [2, 0]
    np.testing.assert_array_equal(
        torch.argmin(x, dim=1).numpy(), np.asarray(jnp.argmin(x.numpy(), 1)))


# ------------------------------------------------------- shared snapshots
@pytest.fixture(scope="module")
def served():
    """One workload, built by both packages (bitwise-equal graphs), with
    both snapshots."""
    wl = tc.make_workload(n=2000, d=16, nq=64, seed=0, k=10)
    kw = dict(dim=16, m=8, ef_construction=32, o=4, seed=0)
    ti, ri = tc.WoWIndex(**kw), rc.WoWIndex(**kw)
    ti.insert_batch(wl.vectors, wl.attrs, batch_size=128)
    ri.insert_batch(wl.vectors, wl.attrs, batch_size=128)
    tsnap, rsnap = take_snapshot(ti), ref_take_snapshot(ri)
    for f in ("vectors", "neighbors", "uvals", "uval_rep", "ids_map"):
        np.testing.assert_array_equal(getattr(tsnap, f), getattr(rsnap, f))
    scale = float(tsnap.sq_norms.max() + (wl.queries**2).sum(1).max())
    return wl, tsnap, rsnap, scale


@pytest.mark.parametrize("vec_dtype", ["f32", "int8", "bf16"])
def test_to_device_index_padding(served, vec_dtype):
    _, tsnap, rsnap, _ = served
    di = tds.to_device_index(tsnap, vec_dtype=vec_dtype, device=CPU)
    jdi = rds.to_device_index(rsnap, vec_dtype=vec_dtype)
    assert di.vectors.shape[0] == 2048 and di.uvals.shape[0] == 2048
    if vec_dtype == "bf16":
        np.testing.assert_array_equal(
            di.vectors.view(torch.int16).numpy().view(np.uint16),
            np.asarray(jdi.vectors).view(np.uint16))
    else:
        np.testing.assert_array_equal(di.vectors.numpy(),
                                      np.asarray(jdi.vectors))
    for f in ("sq_norms", "attrs", "neighbors", "uvals", "uval_rep",
              "scales"):
        np.testing.assert_array_equal(getattr(di, f).numpy(),
                                      np.asarray(getattr(jdi, f)), f)
    # pads are unreachable: -1 neighbor rows, +inf attrs / uvals
    assert (di.neighbors[:, 2000:] == -1).all()
    assert torch.isinf(di.attrs[2000:]).all()


def test_landing_and_entry_bitwise(served):
    wl, tsnap, rsnap, _ = served
    di = tds.to_device_index(tsnap, device=CPU)
    jdi = rds.to_device_index(rsnap)
    amin, amax = float(wl.attrs.min()), float(wl.attrs.max())
    ranges = np.concatenate([
        wl.ranges,
        [[amax + 10, amax + 20], [wl.attrs[5], wl.attrs[5]], [amin, amax],
         [amin - 50, amin - 1], [1.0, 0.0], [-np.inf, np.inf]],
    ]).astype(np.float32)
    L = tsnap.num_layers
    got = tds._landing_and_entry(di, torch.from_numpy(ranges), 4, L)
    exp = rds._landing_and_entry(jdi, jnp.asarray(ranges), 4, L)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_hop_states_match_stepwise(served, visited):
    """Init + the first 8 hops, state field by state field."""
    wl, tsnap, rsnap, scale = served
    B = 16
    q, r = wl.queries[:B], wl.ranges[:B].astype(np.float32)
    tcfg = tds.hop_cfg(k=10, width=32, m=8, visited=visited, backend="ref")
    jcfg = rds.hop_cfg(k=10, width=32, m=8, visited=visited, backend="ref")
    di = tds.to_device_index(tsnap, device=CPU)
    jdi = rds.to_device_index(rsnap)
    st = tds._init_state(di, torch.from_numpy(q), torch.from_numpy(r), tcfg)
    jst = rds._init_state(jdi, jnp.asarray(q), jnp.asarray(r), jcfg)
    for hop in range(9):
        for f in ("l_d", "ep", "res_i", "res_e", "active", "dc", "hops"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                f"{f} after {hop} hops")
        np.testing.assert_array_equal(_u32(st.vstate), np.asarray(jst.vstate))
        np.testing.assert_allclose(st.res_d.numpy(), np.asarray(jst.res_d),
                                   rtol=1e-5, atol=1e-5 * scale)
        assert st.t == int(jst.t)
        st = tds._hop_body(di, tcfg, st)
        jst = rds._hop_body(jdi, jcfg, jst)


# ------------------------------------------------------------- end to end
def _jax_result(rsnap, wl, **kw):
    res = rds.search_batch(rsnap, wl.queries, wl.ranges, k=10, width=32,
                           backend="ref", **kw)
    return tds.SearchResult(*(np.asarray(a) for a in res))


def _assert_tie_rule(got, exp, scale):
    rep = tds.compare_results(got, exp, scale=scale)
    assert rep["faults"] == [], rep
    assert len(rep["tie_flips"]) <= 0.02 * rep["queries"], rep


@pytest.mark.parametrize("vec_dtype", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("compact", [None, (8, 8)])
@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_search_batch_matches_jax(served, visited, compact, vec_dtype):
    wl, tsnap, rsnap, scale = served
    kw = dict(visited=visited, compact=compact, vec_dtype=vec_dtype)
    exp = _jax_result(rsnap, wl, **kw)
    carried = tds.search_batch(tds.from_reference(rsnap), wl.queries,
                               wl.ranges, k=10, width=32, device=CPU, **kw)
    built = tds.search_batch(tsnap, wl.queries, wl.ranges, k=10, width=32,
                             device=CPU, **kw)
    _assert_tie_rule(carried, exp, scale)
    for a, b in zip(built, carried):  # the same snapshot, the same bits
        np.testing.assert_array_equal(a, b)


def test_from_reference_carries_quantized_slabs(served):
    """A reference snapshot with a pre-quantized bf16 slab (ml_dtypes
    there) serves from its carried bits, not a re-quantization."""
    from repro.core.store import quantize_rows as ref_quantize_rows

    wl, _, rsnap, scale = served
    slab, _ = ref_quantize_rows(rsnap.vectors, "bf16")
    rq = rsnap.__class__(**{**rsnap.__dict__, "q_vectors": slab,
                            "vec_dtype": "bf16"})
    snap = tds.from_reference(rq)
    assert snap.q_vectors.dtype == np.uint16 and snap.vec_dtype == "bf16"
    np.testing.assert_array_equal(snap.q_vectors, slab.view(np.uint16))
    got = tds.search_batch(snap, wl.queries, wl.ranges, k=10, width=32,
                           device=CPU)
    _assert_tie_rule(got, _jax_result(rq, wl), scale)
    assert tds.from_reference(rq, vec_dtype="int8").q_vectors is None


def test_max_hops_truncation_matches(served):
    wl, tsnap, rsnap, scale = served
    got = tds.search_batch(tsnap, wl.queries, wl.ranges, k=10, width=32,
                           max_hops=5, device=CPU)
    exp = _jax_result(rsnap, wl, max_hops=5)
    assert got.hops.max() <= 5
    _assert_tie_rule(got, exp, scale)


def test_cosine_metric_matches():
    """metric != l2: queries normalised at init, distances 1 - dot."""
    rng = np.random.default_rng(0)
    n, d = 700, 8
    vecs = rng.integers(-8, 8, size=(n, d)).astype(np.float32)
    attrs = rng.permutation(n).astype(np.float64)
    kw = dict(dim=d, m=8, ef_construction=32, o=4, seed=0, metric="cosine")
    ti, ri = tc.WoWIndex(**kw), rc.WoWIndex(**kw)
    ti.insert_batch(vecs, attrs)
    ri.insert_batch(vecs, attrs)
    qs = rng.integers(-8, 8, size=(24, d)).astype(np.float32)
    qs[0] = 0.0  # zero query: the norm guard
    ranges = np.sort(rng.uniform(0, n, size=(24, 2)), axis=1)
    got = tds.search_batch(take_snapshot(ti), qs, ranges, k=10, width=32,
                           device=CPU)
    exp = rds.search_batch(ref_take_snapshot(ri), qs, ranges, k=10,
                           width=32, backend="ref")
    exp = tds.SearchResult(*(np.asarray(a) for a in exp))
    _assert_tie_rule(got, exp, 2.0)


def test_compare_results_classifies():
    ids = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    d = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 2.0], [1.0, 2.0, 3.0]],
                 np.float32)
    one = np.ones(3, np.int32)
    a = tds.SearchResult(ids, d, one, one)
    flipped, fd = ids.copy(), d.copy()
    flipped[1] = [4, 6, 5]  # equal distances at the swapped slots
    flipped[2], fd[2, 1] = [7, 10, 9], 2.5  # 2.0 vs 2.5: not a tie
    b = tds.SearchResult(flipped, fd, one, one)
    rep = tds.compare_results(a, b)
    assert rep == {"queries": 3, "tie_flips": [1], "faults": [2]}
    c = tds.SearchResult(ids, d, one + np.array([0, 0, 1], np.int32), one)
    assert tds.compare_results(a, c)["faults"] == [2]


def test_unported_options_and_device_policy(served):
    _, tsnap, _, _ = served
    with pytest.raises(NotImplementedError, match="A9"):
        tds.hop_cfg(pipeline="reference")
    with pytest.raises(ValueError):
        tds.hop_cfg(visited="cuckoo")
    with pytest.raises(ValueError):
        tds.hop_cfg(backend="pallas")
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tds.to_device_index(tsnap)
