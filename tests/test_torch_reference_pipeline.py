"""repro_torch reference hop pipeline vs ``repro.core.hop_reference`` and
the JAX package's ``pipeline="reference"`` search.

Stage level: ``batched_dot_ref``/``l2_distance_ref`` against the jnp
oracles and the Pallas kernel (interpret mode), rtol 1e-5 and atol
1e-5*|v|*|q| per dot (1e-5*(|v|^2 + |q|^2) per factorised L2, whose terms
cancel); ``dedupe_pairwise``, ``merge_full_sort`` and the dense hash
helpers bitwise.

End to end: ``search_batch(pipeline="reference")`` against JAX's reference
pipeline and against the port's own fused pipeline, for visited {bitmap,
hash} x compact {None, (8, 8)}, under the tie rule of ``compare_results``
(ids, dc and hops equal per query; dists within 1e-5 of the term size; a
differing query only as a tie flip, on at most 2% of queries); whole hops
bitwise state by state.  The launcher's device build + reference pipeline
+ ingest runs on the CPU.  On a card, the CUDA kernel against its plain
version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import device_search as rds
from repro.core import hop_reference as rhr
from repro.core.snapshot import take_snapshot as ref_take_snapshot
from repro.kernels import ref as jref
from repro.kernels.distance import batched_dot as pallas_batched_dot
from repro_torch import core as tc
from repro_torch.core import device_search as tds
from repro_torch.core import hop_reference as thr
from repro_torch.core.snapshot import take_snapshot
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_kernels import cuda_device  # noqa: F401  (the fixture)

_BIG = 2**30
CPU = "cpu"
SHAPES = [(2, 7, 16), (4, 33, 8), (1, 1, 5), (5, 17, 128), (3, 9, 33)]


def _close(got, exp, atol):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    excess = np.abs(got - exp) - (1e-5 * np.abs(exp) + atol + 1e-30)
    assert np.all(excess <= 0), np.max(excess)


# ------------------------------------------------------------- the kernel
@pytest.mark.parametrize("B,K,D", SHAPES)
def test_batched_dot_and_l2_ref_match_jax(B, K, D):
    """Plain versions == jnp oracles == Pallas kernel (interpret)."""
    rng = np.random.default_rng(B * 97 + K + D)
    v = rng.normal(size=(B, K, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    v2 = (v.astype(np.float64) ** 2).sum(-1)
    q2 = (q.astype(np.float64) ** 2).sum(-1)[:, None]
    got = tref.batched_dot_ref(torch.from_numpy(v), torch.from_numpy(q))
    dot_tol = 1e-5 * np.sqrt(v2 * q2)
    _close(got, jref.batched_dot_ref(jnp.asarray(v), jnp.asarray(q)), dot_tol)
    _close(got, pallas_batched_dot(jnp.asarray(v), jnp.asarray(q),
                                   interpret=True), dot_tol)
    norms = v2.astype(np.float32)
    l2 = tref.l2_distance_ref(torch.from_numpy(v), torch.from_numpy(q),
                              torch.from_numpy(norms))
    exp = jref.l2_distance_ref(jnp.asarray(v), jnp.asarray(q),
                               jnp.asarray(norms))
    _close(l2, exp, 1e-5 * (v2 + q2))
    assert (l2 >= 0).all()


def test_batched_dot_dispatch_on_cpu():
    """auto = plain version for CPU tensors; cuda on a CPU tensor raises;
    the kernel wrapper itself refuses CPU tensors."""
    from repro_torch.kernels.distance import batched_dot, l2_distance

    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(3, 5, 8)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    nrm = (v * v).sum(-1)
    assert torch.equal(tops.batched_dot(v, q), tref.batched_dot_ref(v, q))
    assert torch.equal(tops.l2_distance(v, q, nrm, backend="ref"),
                       tref.l2_distance_ref(v, q, nrm))
    for fn, args in ((tops.batched_dot, (v, q)),
                     (tops.l2_distance, (v, q, nrm))):
        with pytest.raises(ValueError):
            fn(*args, backend="cuda")
        with pytest.raises(ValueError):
            fn(*args, backend="pallas")
    with pytest.raises(ValueError):
        batched_dot(v, q)
    with pytest.raises(ValueError):
        l2_distance(v, q, nrm)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D,offset", [
    (8, 17, 128, 0), (256, 17, 128, 0), (128, 48, 128, 0), (5, 9, 33, 0),
    (4, 33, 24, 0), (3, 3, 1, 0), (7, 5, 1, 0), (6, 9, 3, 0),
    (4, 11, 127, 0), (256, 17, 128, 1), (5, 9, 33, 1), (6, 9, 3, 1),
    (1024, 33, 8, 0), (512, 17, 24, 1), (2, 3, 5000, 1)])
def test_cuda_batched_dot_matches_plain(cuda_device, B, K, D, offset):
    """The hand-written kernel against its plain version on the card, at
    the serving shapes, at D that leave floats at the ends of a block's
    16-byte-aligned middle (1, 3, 24, 33, 127), with the slab starting
    ``offset`` floats into its storage (unaligned at 1), with many rows
    packed into a block (D 8 and 24 at B*K 33,792 and 8,704) and with rows
    longer than a block's pass (D 5,000)."""
    from repro_torch.kernels.distance import LAUNCHES, batched_dot

    rng = np.random.default_rng(B + K + D)
    v = torch.from_numpy(rng.normal(size=(B, K, D)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    store = torch.empty(offset + B * K * D, device=cuda_device)
    store[offset:] = v.flatten().to(cuda_device)
    v, q = store[offset:].view(B, K, D), q.to(cuda_device)
    assert v.is_contiguous() and v.storage_offset() == offset
    before = LAUNCHES["batched_dot"]
    got = batched_dot(v, q)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_dot"] == before + 1
    exp = tref.batched_dot_ref(v.double(), q.double())
    v2 = (v.double() ** 2).sum(-1)
    q2 = (q.double() ** 2).sum(-1)[:, None]
    _close(got.cpu(), exp.cpu(), (1e-5 * (v2 * q2).sqrt()).cpu().numpy())


# ------------------------------------------------------------- stage level
def _ranked(rng, B, F, n_ids):
    """ids with duplicates and injective eligible ranks (others _BIG)."""
    ids = rng.integers(0, n_ids, size=(B, F)).astype(np.int32)
    rank = np.stack([rng.permutation(F) for _ in range(B)]).astype(np.int32)
    rank = np.where(rng.random((B, F)) < 0.7, rank, _BIG).astype(np.int32)
    return ids, rank


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedupe_pairwise_bitwise(seed):
    rng = np.random.default_rng(seed)
    ids, rank = _ranked(rng, 6, 48, 20)
    gi, gr = thr.dedupe_pairwise(torch.from_numpy(ids).long(),
                                 torch.from_numpy(rank).long())
    ei, er = rhr.dedupe_pairwise(jnp.asarray(ids), jnp.asarray(rank))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(er))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_full_sort_bitwise(seed):
    """Stable on ties: an existing result stays ahead of a new candidate
    at an equal distance, and equal new candidates keep slot order."""
    rng = np.random.default_rng(seed)
    B, W, K = 5, 16, 9
    levels = np.asarray([0.5, 1.0, 1.5, 2.0, np.inf], np.float32)
    res_d = np.sort(rng.choice(levels, size=(B, W)), axis=1)
    res_i = rng.integers(0, 1000, size=(B, W)).astype(np.int32)
    res_e = rng.random((B, W)) < 0.5
    dd = rng.choice(levels, size=(B, K))
    new_i = rng.integers(1000, 2000, size=(B, K)).astype(np.int32)
    new_e = rng.random((B, K)) < 0.5
    got = thr.merge_full_sort(
        torch.from_numpy(res_d), torch.from_numpy(res_i).long(),
        torch.from_numpy(res_e), torch.from_numpy(dd),
        torch.from_numpy(new_i).long(), torch.from_numpy(new_e), W)
    exp = rhr.merge_full_sort(
        jnp.asarray(res_d), jnp.asarray(res_i), jnp.asarray(res_e),
        jnp.asarray(dd), jnp.asarray(new_i), jnp.asarray(new_e), W)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_dense_hash_helpers_match_packed_filter():
    """The dense numpy filter equals JAX's and the unpacked port filter
    after the same marks."""
    rng = np.random.default_rng(11)
    cfg = tds.hop_cfg(visited="hash", visited_bits=2**12, m=8)
    B, K = 4, 9
    ids = rng.integers(0, 5000, size=(B, K)).astype(np.int32)
    valid = rng.random((B, K)) < 0.8
    vstate = torch.zeros((B, cfg.v_words + 1), dtype=torch.int64)
    tds._visited_mark(vstate, torch.from_numpy(ids), torch.from_numpy(valid),
                      cfg)
    dense0 = np.zeros((B, cfg.v_words * 32), np.uint8)
    dense = thr.hash_mark_dense(dense0, ids, valid, cfg.v_hashes)
    np.testing.assert_array_equal(
        dense, rhr.hash_mark_dense(dense0, ids, valid, cfg.v_hashes))
    np.testing.assert_array_equal(thr.unpack_filter(vstate), dense)
    probe = rng.integers(0, 5000, size=(B, 30)).astype(np.int32)
    np.testing.assert_array_equal(
        thr.hash_test_dense(dense, probe, cfg.v_hashes),
        rhr.hash_test_dense(dense, probe, cfg.v_hashes))
    assert thr.hash_test_dense(dense, ids, cfg.v_hashes)[valid].all()


# ------------------------------------------------------- shared snapshots
@pytest.fixture(scope="module")
def served():
    """One workload, built by both packages (bitwise-equal graphs)."""
    wl = tc.make_workload(n=2000, d=16, nq=64, seed=0, k=10)
    kw = dict(dim=16, m=8, ef_construction=32, o=4, seed=0)
    ti, ri = tc.WoWIndex(**kw), rc.WoWIndex(**kw)
    ti.insert_batch(wl.vectors, wl.attrs, batch_size=128)
    ri.insert_batch(wl.vectors, wl.attrs, batch_size=128)
    tsnap, rsnap = take_snapshot(ti), ref_take_snapshot(ri)
    np.testing.assert_array_equal(tsnap.neighbors, rsnap.neighbors)
    scale = float(tsnap.sq_norms.max() + (wl.queries**2).sum(1).max())
    return wl, tsnap, rsnap, scale


@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_reference_hop_states_match_jax_stepwise(served, visited):
    """Init + the first 8 reference hops, state field by state field
    (integers bitwise, dists within the term-size tolerance)."""
    wl, tsnap, rsnap, scale = served
    B = 16
    q, r = wl.queries[:B], wl.ranges[:B].astype(np.float32)
    kw = dict(k=10, width=32, m=8, visited=visited, backend="ref",
              pipeline="reference")
    tcfg, jcfg = tds.hop_cfg(**kw), rds.hop_cfg(**kw)
    di = tds.to_device_index(tsnap, device=CPU)
    jdi = rds.to_device_index(rsnap)
    st = tds._init_state(di, torch.from_numpy(q), torch.from_numpy(r), tcfg)
    jst = rds._init_state(jdi, jnp.asarray(q), jnp.asarray(r), jcfg)
    for hop in range(9):
        for f in ("l_d", "ep", "res_i", "res_e", "active", "dc", "hops"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                f"{f} after {hop} hops")
        np.testing.assert_array_equal(st.vstate.numpy().astype(np.uint32),
                                      np.asarray(jst.vstate))
        np.testing.assert_allclose(st.res_d.numpy(), np.asarray(jst.res_d),
                                   rtol=1e-5, atol=1e-5 * scale)
        st = tds._hop_body(di, tcfg, st)
        jst = rds._hop_body(jdi, jcfg, jst)


def _assert_tie_rule(got, exp, scale):
    rep = tds.compare_results(got, exp, scale=scale)
    assert rep["faults"] == [], rep
    assert len(rep["tie_flips"]) <= 0.02 * rep["queries"], rep


@pytest.mark.parametrize("compact", [None, (8, 8)])
@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_reference_search_matches_jax_and_fused(served, visited, compact):
    wl, tsnap, rsnap, scale = served
    kw = dict(k=10, width=32, visited=visited, compact=compact)
    exp = rds.search_batch(rsnap, wl.queries, wl.ranges, backend="ref",
                           pipeline="reference", **kw)
    exp = tds.SearchResult(*(np.asarray(a) for a in exp))
    got = tds.search_batch(tsnap, wl.queries, wl.ranges, device=CPU,
                           pipeline="reference", **kw)
    fused = tds.search_batch(tsnap, wl.queries, wl.ranges, device=CPU,
                             pipeline="fused", **kw)
    _assert_tie_rule(got, exp, scale)
    _assert_tie_rule(got, fused, scale)


def test_reference_pipeline_rejects_quantized(served):
    wl, tsnap, _, _ = served
    with pytest.raises(ValueError, match="f32 vector slab"):
        tds.search_batch(tsnap, wl.queries, wl.ranges, device=CPU,
                         pipeline="reference", vec_dtype="int8")


# ------------------------------------------------------------- the launcher
def test_launcher_device_build_reference_ingest(capsys):
    """``--build-backend device --pipeline fused reference --ingest`` on the
    CPU: both pipelines answer alike before and after the ingest, recall
    holds, and the incremental snapshot covers the ingested rows."""
    from repro_torch.launch import serve

    out = serve.main([
        "--device", "cpu", "--n", "1200", "--dim", "16", "--queries", "40",
        "--width", "32", "--m", "8", "--ef-construction", "32",
        "--build-backend", "device", "--pipeline", "fused", "reference",
        "--visited", "bitmap", "hash", "--ingest", "200",
    ])
    printed = capsys.readouterr().out
    assert "[batched/device (micro-batch 128)]" in printed
    assert "ingested 200 vectors" in printed
    assert out["build_backend"] == "device" and out["arena_bytes"] > 0
    assert out["snapshot_after"].n == 1400
    wl, snap = out["workload"], out["snapshot"]
    scale = float(snap.sq_norms.max() + (wl.queries**2).sum(1).max())
    for runs in (out["runs"], out["ingest_runs"]):
        assert len(runs) == 4
        by = {(r["pipeline"], r["visited"]): r for r in runs}
        for visited in ("bitmap", "hash"):
            ref, fused = by[("reference", visited)], by[("fused", visited)]
            _assert_tie_rule(ref["result"], fused["result"], scale)
            assert ref["recall"] >= 0.9 and fused["recall"] >= 0.9
            assert ref["launches"] == {"gather_norm_dot": 0,
                                       "batched_dot": 0,
                                       "flash_attention": 0, "wkv6": 0,
                                       "mamba_scan": 0}


def test_launcher_rejects_reference_with_quantized_slab():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--pipeline", "reference",
                    "--vec-dtype", "f32", "int8"])
