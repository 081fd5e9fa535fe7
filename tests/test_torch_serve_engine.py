"""The port's request-lifecycle engine (``repro_torch.serve.lifecycle``)
against the invariants of ``tests/test_serve_engine.py`` and against the
JAX package's ``ServeEngine``, on the CPU at the reference's reduced size
(n = 500, d = 12, 40 queries, the ``SEARCH`` knobs).

Ported here: the query side and the non-durable ingest — bitwise equality
with a one-shot ``search_batch`` under interleaved waves, warm-up, a bare
snapshot, backpressure, shedding, deadlines, fault plans, the adaptive
knobs, the hop budget, per-row ingest validation, ingest/query
interleaving and the stats.  The congestion-collapse case counts served
requests per wave instead of host seconds.  The five durable cases of the
reference (mmap cold start, an acked ingest surviving a crash, restart
replay, a dropped fsync, SIGKILL with a pending ingest queue) wait for the
write-ahead log and checkpoints (ROADMAP A6).

Parity: the same submission sequence through both engines over the same
seeded index (built by the port, whose host build equals the
reference's, and a reference snapshot carried over with
``from_reference``); replies agree under ``compare_results``' tie rule,
with equal hops, DC, degraded flags and counters.  The sizing helpers are
held bitwise to JAX's on seeded histograms and ids.
"""
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import device_search as rds
from repro.core.snapshot import take_snapshot as ref_take_snapshot
from repro.persist import EngineFaultPlan as RefFaultPlan
from repro.serve import lifecycle as rl
from repro_torch.core import WoWIndex, make_workload
from repro_torch.core import device_search as tds
from repro_torch.core.device_search import (
    SearchResult, chunk_schedule_from_hist, compare_results, hist_percentile,
    search_batch,
)
from repro_torch.core.snapshot import take_snapshot
from repro_torch.persist import CrashError, EngineFaultPlan
from repro_torch.serve.lifecycle import (
    EngineConfig, Rejected, ServeEngine, Ticket, validate_rows,
)

KW = dict(m=8, ef_construction=32, o=4, seed=0)
SEARCH = dict(k=5, width=32, visited="bitmap", adaptive=False, chunk=(4, 8))
CPU = "cpu"


class VClock:
    """Deterministic virtual clock; ``advance`` doubles as the fault
    plan's ``sleep`` so injected slow waves become pure clock jumps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture(scope="module")
def wl():
    return make_workload(n=500, d=12, nq=40, seed=0, k=5)


def _index(wl, n=None):
    ix = WoWIndex(dim=12, **KW)
    n = len(wl.attrs) if n is None else n
    ix.insert_batch(wl.vectors[:n], wl.attrs[:n], batch_size=128,
                    backend="numpy")
    return ix


@pytest.fixture(scope="module")
def idx(wl):
    return _index(wl)


def _engine(idx, **over):
    kw = dict(SEARCH)
    kw.update(over)
    return ServeEngine(index=idx, config=EngineConfig(**kw), device=CPU)


def _ref(snap, wl, **kw):
    return search_batch(snap, wl.queries, wl.ranges, k=5, width=32,
                        visited="bitmap", device=CPU, **kw)


# ------------------------------------------------------------ parity & waves
def test_engine_bitwise_matches_search_batch(wl, idx):
    """Interleaved multi-wave scheduling returns bitwise the ids AND
    distances of a one-shot ``search_batch`` over the same snapshot."""
    ref = _ref(take_snapshot(idx), wl)
    eng = _engine(idx, max_wave=16)
    tickets, got = [], []
    for i in range(16):
        tickets.append(eng.submit(wl.queries[i], wl.ranges[i]))
    for i in range(16, len(wl.queries)):
        got.extend(eng.step())
        tickets.append(eng.submit(wl.queries[i], wl.ranges[i]))
    got.extend(eng.drain())
    replies = {r.rid: r for r in got}
    assert len(replies) == len(wl.queries)
    for i, t in enumerate(tickets):
        r = replies[t.rid]
        assert not r.degraded and r.reason is None
        np.testing.assert_array_equal(r.ids, ref.ids[i])
        np.testing.assert_array_equal(r.dists, ref.dists[i])
        assert (r.hops, r.dc) == (ref.hops[i], ref.dc[i])
    assert eng.stats.waves >= 3  # the drip produced interleaved waves


def test_warmup_runs_hops_without_touching_state(wl, idx, monkeypatch):
    """``warmup()`` runs every (bucket, chunk) shape with real hops (its
    queries stay active through the steady chunk, so every op of the hop
    body runs before any capture) while leaving the scheduler untouched;
    serving afterwards still matches the one-shot ``search_batch``."""
    seen = []
    real = tds._run_chunk

    def spy(di, st, cfg, h):
        active = int(st.active.sum())
        out = real(di, st, cfg, h)
        seen.append((st.res_i.shape[0], h, active, out.t - st.t))
        return out

    import repro_torch.serve.lifecycle as lc
    monkeypatch.setattr(lc, "_run_hop_chunk", spy)
    eng = _engine(idx, max_wave=16)
    dt = eng.warmup()
    assert dt >= 0.0
    # buckets 8 and 16: the seed chunk (4) and the steady chunk (8) twice
    assert [(B, h) for B, h, _, _ in seen] == [
        (8, 4), (8, 8), (8, 8), (16, 4), (16, 8), (16, 8)]
    for B, h, active, ran in seen:
        assert active == B and ran == h  # every row active, every hop run
    assert eng.idle and eng.in_flight == 0 and eng.queue_len == 0
    s = eng.stats
    assert (s.submitted, s.waves, s.chunks, s.served) == (0, 0, 0, 0)
    assert eng.hop_histogram() is None
    monkeypatch.setattr(lc, "_run_hop_chunk", real)
    ref = _ref(take_snapshot(idx), wl)
    for i in range(12):
        eng.submit(wl.queries[i], wl.ranges[i])
    got = sorted(eng.drain(), key=lambda r: r.rid)
    assert len(got) == 12
    for i, r in enumerate(got):
        assert not r.degraded
        np.testing.assert_array_equal(r.ids, ref.ids[i])
        np.testing.assert_array_equal(r.dists, ref.dists[i])


def test_engine_serves_from_bare_snapshot(wl, idx):
    """A snapshot-only engine answers queries; ingest refuses."""
    eng = ServeEngine(snapshot=take_snapshot(idx),
                      config=EngineConfig(**SEARCH), device=CPU)
    t = eng.submit(wl.queries[0], wl.ranges[0])
    (r,) = eng.drain()
    assert r.rid == t.rid and not r.degraded
    with pytest.raises(RuntimeError, match="ingest needs a live index"):
        eng.submit_ingest(wl.vectors[:2], wl.attrs[:2])


def test_device_policy_and_durable_branches(wl, idx):
    """``device=None`` is the card (raises without CUDA); an index with a
    write-ahead log is refused at ingest until the log is ported."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(index=idx)
    ix = _index(wl, n=100)
    ix._wal = object()  # stands for an attached log
    eng = _engine(ix)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        eng.submit_ingest(wl.vectors[:2], wl.attrs[:2])


# -------------------------------------------------- admission & backpressure
def test_queue_bound_and_retry_after(wl, idx):
    """The admission queue never exceeds its bound: submits past
    ``queue_cap`` are rejected with a positive retry-after hint, and the
    admitted requests are all served."""
    eng = _engine(idx, max_wave=8, queue_cap=8)
    out = [eng.submit(wl.queries[i % len(wl.queries)], (0.0, 1.0))
           for i in range(20)]
    admitted = [o for o in out if isinstance(o, Ticket)]
    rejected = [o for o in out if isinstance(o, Rejected)]
    assert len(admitted) == 8 and len(rejected) == 12
    assert eng.queue_len == 8 and eng.stats.queue_peak == 8
    assert all(r.retry_after > 0 for r in rejected)
    assert all(r.queue_len == 8 for r in rejected)
    replies = eng.drain()
    assert len(replies) == 8
    assert {r.rid for r in replies} == {t.rid for t in admitted}
    s = eng.stats
    assert s.submitted == 20 and s.admitted == 8 and s.rejected == 12
    assert s.served == 8


def test_overload_sheds_wave_width(wl, idx):
    """Sustained pressure flips the engine into load-shedding: waves are
    capped at ``shed_wave``; every admitted request is still served."""
    eng = _engine(idx, max_wave=16, queue_cap=64, high_water=4,
                  shed_after=2, shed_wave=4)
    for i in range(32):
        eng.submit(wl.queries[i % len(wl.queries)], (0.0, 1.0))
    assert eng.overloaded()
    eng.drain()
    s = eng.stats
    assert s.shed_waves > 0
    assert s.served == 32


def test_overload_no_congestion_collapse(wl, idx):
    """Closed-loop flood at 4x the admissible load: the scheduler does the
    same work per wave as without overload — requests served per wave and
    chunks per served request stay within 10% of the non-overloaded
    flood's (counted, not timed: rejection is cheap and never shrinks the
    waves that do run)."""
    eng = _engine(idx, max_wave=16, queue_cap=32)
    q, r = wl.queries, wl.ranges

    def flood(n_submit):
        s0 = dict(vars(eng.stats))
        for i in range(n_submit):
            eng.submit(q[i % len(q)], r[i % len(r)])
        served = len(eng.drain())
        waves = eng.stats.waves - s0["waves"]
        chunks = eng.stats.chunks - s0["chunks"]
        return served, served / waves, chunks / served

    served, base_per_wave, base_chunks = flood(32)  # fills the queue
    assert served == 32
    served, over_per_wave, over_chunks = flood(128)  # 96 rejected
    assert served == 32 and eng.stats.rejected == 96
    assert over_per_wave >= 0.9 * base_per_wave, (over_per_wave,
                                                 base_per_wave)
    assert over_chunks <= 1.1 * base_chunks, (over_chunks, base_chunks)
    assert eng.stats.queue_peak <= 32


def test_retry_after_cold_start_bounded_positive(wl, idx):
    """The first rejections, before any chunk ran (EWMA 0), carry a
    bounded positive retry-after hint."""
    eng = _engine(idx, max_wave=4, queue_cap=2)
    out = [eng.submit(wl.queries[i], wl.ranges[i]) for i in range(6)]
    rejected = [o for o in out if isinstance(o, Rejected)]
    assert len(rejected) == 4
    assert eng.stats.waves == 0
    for r in rejected:
        assert np.isfinite(r.retry_after)
        assert 0.0 < r.retry_after <= ServeEngine.RETRY_AFTER_MAX_S
    eng.drain()


def test_retry_after_survives_poisoned_ewma(wl, idx):
    """The hint stays bounded positive for every degenerate EWMA value,
    and a non-finite clock delta is skipped by the EWMA update."""
    eng = _engine(idx, max_wave=4, queue_cap=1)
    for bad in (float("nan"), float("inf"), -1.0, 0.0):
        eng._wave_s = bad
        hint = eng._retry_after()
        assert np.isfinite(hint), f"_wave_s={bad}: hint {hint}"
        assert 0.0 < hint <= eng.RETRY_AFTER_MAX_S
    clk = VClock()
    plan = EngineFaultPlan(slow_chunk_every=1, slow_chunk_s=float("inf"),
                           sleep=clk.advance)
    eng2 = ServeEngine(index=idx, now=clk, fault_plan=plan,
                       config=EngineConfig(**SEARCH, max_wave=4), device=CPU)
    for i in range(4):
        eng2.submit(wl.queries[i], wl.ranges[i])
    replies = eng2.drain()
    assert len(replies) == 4
    assert np.isfinite(eng2._wave_s) and np.isfinite(eng2._hop_s)
    hint = eng2._retry_after()
    assert np.isfinite(hint) and 0.0 < hint <= eng2.RETRY_AFTER_MAX_S


# ------------------------------------------------------ deadlines & shedding
def test_deadline_storm_degrades_never_times_out(wl, idx):
    """Deadline storm under injected slow chunks: every reply past its
    deadline is degraded (truncated in flight with its best-so-far beam,
    or expired in the queue with an empty reply); the engine drains."""
    clk = VClock()
    plan = EngineFaultPlan(slow_chunk_every=1, slow_chunk_s=0.1,
                           sleep=clk.advance)
    eng = ServeEngine(
        index=idx, now=clk, fault_plan=plan, device=CPU,
        config=EngineConfig(**SEARCH, max_wave=8, max_slots=16,
                            default_timeout_s=0.05),
    )
    for i in range(32):
        eng.submit(wl.queries[i % len(wl.queries)], (0.0, 1.0))
    replies = eng.drain()
    assert len(replies) == 32
    assert all(r.degraded for r in replies)
    truncated = [r for r in replies if r.reason == "deadline"]
    expired = [r for r in replies if r.reason == "queue_deadline"]
    assert len(truncated) + len(expired) == 32
    assert truncated and expired
    for r in replies:
        assert r.finish_t > (r.finish_t - r.latency_s) + 0.05 - 1e-9
        assert len(r.ids) == 5 and len(r.dists) == 5
    for r in expired:
        assert (r.ids == -1).all() and r.hops == 0
    s = eng.stats
    assert s.degraded == 32 and s.expired == len(expired)


def test_degraded_reply_is_valid_prefix(wl, idx):
    """A mid-flight truncation returns the beam's best-so-far: sorted, at
    least one id, fewer hops than the full run."""
    full = _ref(take_snapshot(idx), wl)
    clk = VClock()
    plan = EngineFaultPlan(slow_chunk_every=1, slow_chunk_s=0.1,
                           sleep=clk.advance)
    eng = ServeEngine(
        index=idx, now=clk, fault_plan=plan, device=CPU,
        config=EngineConfig(**SEARCH, max_wave=64, default_timeout_s=0.25),
    )
    tickets = [eng.submit(wl.queries[i], wl.ranges[i])
               for i in range(len(wl.queries))]
    replies = {r.rid: r for r in eng.drain()}
    saw_truncated = False
    for i, t in enumerate(tickets):
        r = replies[t.rid]
        got = r.dists[r.ids >= 0]
        assert np.all(np.diff(got) >= 0)
        if r.reason == "deadline" and r.hops < full.hops[i]:
            saw_truncated = True
            assert (r.ids >= 0).any()
    assert saw_truncated


def test_queued_expiry_without_execution(wl, idx):
    """Requests whose deadline passes while still queued are answered
    empty-and-degraded without reaching the hop loop."""
    clk = VClock()
    eng = ServeEngine(index=idx, now=clk, device=CPU,
                      config=EngineConfig(**SEARCH, default_timeout_s=0.01))
    for i in range(4):
        eng.submit(wl.queries[i], wl.ranges[i])
    clk.advance(1.0)
    replies = eng.drain()
    assert len(replies) == 4
    assert all(r.degraded and r.reason == "queue_deadline" for r in replies)
    assert eng.stats.expired == 4 and eng.stats.chunks == 0


def test_crash_after_chunks_fault(wl, idx):
    """``EngineFaultPlan(crash_after_chunks=...)`` kills the scheduler at
    an exact chunk boundary."""
    plan = EngineFaultPlan(crash_after_chunks=1)
    eng = ServeEngine(index=idx, fault_plan=plan, device=CPU,
                      config=EngineConfig(**SEARCH, max_wave=8))
    for i in range(8):
        eng.submit(wl.queries[i], wl.ranges[i])
    with pytest.raises(CrashError):
        eng.drain()
    assert plan.chunks == 2


# ----------------------------------------------------------- adaptive knobs
def test_chunk_schedule_from_hist():
    """The hist-driven chunk schedule is pow2, bounded, and tracks the
    distribution."""
    tight = np.zeros(65, np.int64)
    tight[6] = 100
    h0, h1 = chunk_schedule_from_hist(tight)
    assert h0 == 8 and h1 == 4
    heavy = np.zeros(129, np.int64)
    heavy[20] = 90
    heavy[120] = 10
    g0, g1 = chunk_schedule_from_hist(heavy)
    assert g0 >= 16 and g1 >= 16
    for v in (h0, h1, g0, g1):
        assert v & (v - 1) == 0 and 4 <= v <= 64
    assert hist_percentile(tight, 50.0) == 6.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sizing_helpers_bitwise(seed):
    """``hist_percentile``, ``visited_filter_bits_{measured,from_hist}``,
    ``chunk_schedule_from_hist``, ``_hash_positions`` and ``_visited_test``
    equal JAX's on seeded histograms and ids."""
    rng = np.random.default_rng(seed)
    hops = rng.integers(0, 40 + 60 * seed, size=200)
    hops[: seed * 7] += 300  # a straggler tail
    hist = np.bincount(hops)
    for q in (0.0, 37.5, 50.0, 90.0, 99.0, 100.0):
        assert hist_percentile(hist, q) == rds.hist_percentile(hist, q)
        assert hist_percentile(hist, q) == pytest.approx(
            np.percentile(hops, q), abs=1e-9)
    for m in (8, 16):
        assert tds.visited_filter_bits_measured(hops, m) == \
            rds.visited_filter_bits_measured(hops, m)
        assert tds.visited_filter_bits_from_hist(hist, m) == \
            rds.visited_filter_bits_from_hist(hist, m)
        assert tds.visited_filter_bits_from_hist(hist, m) == \
            tds.visited_filter_bits_measured(hops, m)
    assert chunk_schedule_from_hist(hist) == rds.chunk_schedule_from_hist(hist)
    assert tds.visited_filter_bits_measured(np.zeros(0), 8) == \
        rds.visited_filter_bits_measured(np.zeros(0), 8)

    ids = np.concatenate([rng.integers(0, 2**31 - 1, size=120),
                          [0, 1, 2**31 - 1, -1, -7]]).astype(np.int32)
    ids = ids[: 5 * (len(ids) // 5)].reshape(5, -1)
    for v_bits, nh in ((2**12, 2), (2**16, 3)):
        np.testing.assert_array_equal(
            tds._hash_positions(torch.from_numpy(ids), v_bits, nh).numpy(),
            np.asarray(rds._hash_positions(jnp.asarray(ids), v_bits, nh)))
    for visited in ("bitmap", "hash"):
        kw = dict(k=5, width=32, m=8, visited=visited, visited_bits=2**12)
        tcfg, jcfg = tds.hop_cfg(**kw), rds.hop_cfg(**kw)
        n = 1000
        words = (n + 31) // 32 if visited == "bitmap" else tcfg.v_words
        vstate = rng.integers(0, 2**32, size=(4, words + 1), dtype=np.uint64)
        vstate[:, -1] = 0
        vstate = vstate.astype(np.uint32)
        cand = rng.integers(0, n, size=(4, 3, 8)).astype(np.int32)
        valid = rng.random((4, 3, 8)) < 0.8
        got = tds._visited_test(torch.from_numpy(vstate.astype(np.int64)),
                                torch.from_numpy(cand),
                                torch.from_numpy(valid), tcfg)
        exp = rds._visited_test(jnp.asarray(vstate), jnp.asarray(cand),
                                jnp.asarray(valid), jcfg)
        np.testing.assert_array_equal(got.numpy() & valid,
                                      np.asarray(exp) & valid)


def test_engine_adaptive_filter_and_chunks(wl, idx):
    """With ``visited='hash'`` + adaptive, the engine re-sizes the visited
    filter and chunk schedule from its own live hop histogram."""
    eng = ServeEngine(index=idx, device=CPU, config=EngineConfig(
        k=5, width=32, visited="hash", adaptive=True, max_wave=16))
    assert eng.hop_histogram() is None
    for i in range(16):
        eng.submit(wl.queries[i], wl.ranges[i])
    eng.drain()
    hist = eng.hop_histogram()
    assert hist is not None and hist.sum() == 16
    bits = eng.engine_stats()["visited_bits"]
    assert isinstance(bits, int) and bits & (bits - 1) == 0
    assert bits == rds.visited_filter_bits_from_hist(hist, take_snapshot(
        idx).m)
    h0, h1 = eng.engine_stats()["chunk_schedule"]
    assert (h0, h1) == rds.chunk_schedule_from_hist(hist)
    for i in range(16):
        eng.submit(wl.queries[i], wl.ranges[i])
    replies = eng.drain()
    assert sum(not r.degraded for r in replies) == 16


def test_search_batch_max_hops_budget(wl, idx):
    """``search_batch(max_hops=...)`` caps the hop count (queries that
    finished under the cap are the full run's), and the engine under the
    same budget replies exactly that: its harvest reads the host-side
    plan of hops, which a chunk that runs all its hops (a replayed graph)
    cannot move."""
    snap = take_snapshot(idx)
    full = _ref(snap, wl)
    capped = _ref(snap, wl, max_hops=8)
    hf, hc = np.asarray(full.hops), np.asarray(capped.hops)
    assert hc.max() <= 8 and hf.max() > 8
    done = hf <= 8
    assert done.any()
    np.testing.assert_array_equal(capped.ids[done], full.ids[done])
    eng = _engine(idx, max_wave=16, max_hops=8)
    tickets = [eng.submit(wl.queries[i], wl.ranges[i])
               for i in range(len(wl.queries))]
    replies = {r.rid: r for r in eng.drain()}
    for i, t in enumerate(tickets):
        r = replies[t.rid]
        assert not r.degraded
        np.testing.assert_array_equal(r.ids, capped.ids[i])
        np.testing.assert_array_equal(r.dists, capped.dists[i])
        assert r.hops == capped.hops[i]


# ------------------------------------------------------- ingest (no WAL yet)
def test_ingest_per_row_validation(wl):
    """Half-bad ingest batches commit the good rows and report the bad
    ones explicitly."""
    ix = _index(wl, n=300)
    eng = _engine(ix)
    v = wl.vectors[300:310].copy()
    a = wl.attrs[300:310].copy()
    v[2, 0] = np.nan
    a[5] = np.inf
    n0 = len(ix)
    res = eng.submit_ingest(v, a)
    assert res.accepted == 8 and res.pending
    assert dict(res.rejected) == {2: "non-finite vector component",
                                  5: "non-finite attribute"}
    eng.drain()
    assert len(ix) == n0 + 8
    with pytest.raises(ValueError, match="dimension"):
        eng.submit_ingest(np.zeros((2, 5), np.float32), [0.1, 0.2])
    keep, rej = validate_rows(np.zeros((3, 12), np.float32),
                              np.asarray([0.1, np.nan, 0.3]), 12)
    assert keep.tolist() == [True, False, True] and len(rej) == 1
    assert rl.validate_rows(np.zeros((3, 12), np.float32),
                            np.asarray([0.1, np.nan, 0.3]), 12)[1] == rej


def test_ingest_query_interleave_and_visibility(wl):
    """Queries and ingest share the scheduler: both progress under one
    drive loop, and a query admitted after the ingest applies sees the
    new rows."""
    ix = _index(wl, n=300)
    eng = ServeEngine(index=ix, device=CPU, config=EngineConfig(
        **SEARCH, max_wave=8, ingest_share=0.5, ingest_batch=32))
    hi = float(wl.attrs.max()) + 1.0
    nv = np.random.default_rng(3).standard_normal((64, 12)).astype(np.float32)
    na = np.linspace(hi, hi + 1.0, 64)
    eng.submit_ingest(nv, na)
    for i in range(16):
        eng.submit(wl.queries[i], wl.ranges[i])
    for _ in range(8):
        eng.step()
    assert eng.pending_ingest == 0
    eng.drain()
    assert len(ix) == 364
    t = eng.submit(nv[0], (hi, hi + 1.0))
    (r,) = eng.drain()
    assert r.rid == t.rid and (r.ids >= 300).all()
    assert r.dists[0] <= 1e-3


# ------------------------------------------------------------------ stats
def test_stats_accounting_consistency(wl, idx):
    """The lifecycle counters tie out."""
    eng = _engine(idx, max_wave=8, queue_cap=16)
    for i in range(24):
        eng.submit(wl.queries[i % len(wl.queries)], (0.0, 1.0))
    eng.drain()
    s = eng.stats.summary()
    assert s["submitted"] == 24
    assert s["submitted"] == s["admitted"] + s["rejected"]
    assert s["served"] == s["admitted"] == 16
    assert 0 < s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert s["qps"] > 0
    assert s["shed_fraction"] == pytest.approx(8 / 24)
    es = eng.engine_stats()
    assert es["queue_len"] == 0 and es["in_flight"] == 0
    assert es["pending_ingest"] == 0
    assert set(es) == set(rl.ServeEngine(
        snapshot=ref_take_snapshot(_jax_index(make_workload(
            n=40, d=12, nq=1, seed=0, k=5))),
        config=rl.EngineConfig(**SEARCH)).engine_stats())


# --------------------------------------------------------- parity with JAX
def _jax_index(wl, n=None):
    ix = rc.WoWIndex(dim=12, **KW)
    n = len(wl.attrs) if n is None else n
    ix.insert_batch(wl.vectors[:n], wl.attrs[:n], batch_size=128,
                    backend="numpy")
    return ix


COUNTERS = ("submitted", "admitted", "rejected", "served", "degraded",
            "expired", "waves", "chunks", "shed_waves", "queue_peak",
            "ingest")


def _drive(eng, wl, scenario, nv=None, na=None):
    """One submission sequence: ``drip`` (16 at once, then one a step,
    an ingest between) or ``storm`` (32 at once under a deadline)."""
    if scenario == "storm":
        for i in range(32):
            eng.submit(wl.queries[i % len(wl.queries)], wl.ranges[i % 40])
        return eng.drain()
    got = []
    for i in range(16):
        eng.submit(wl.queries[i], wl.ranges[i])
    for i in range(16, len(wl.queries)):
        got.extend(eng.step())
        eng.submit(wl.queries[i], wl.ranges[i])
        if i == 20 and nv is not None:
            eng.submit_ingest(nv, na)
    got.extend(eng.drain())
    if nv is not None:  # a query on the ingested rows alone
        eng.submit(nv[0], (float(na.min()), float(na.max())))
        got.extend(eng.drain())
    return got


@pytest.mark.parametrize("source", ["port_built", "from_reference"])
@pytest.mark.parametrize("scenario", ["drip", "storm"])
def test_engine_matches_jax_engine(wl, source, scenario):
    """The JAX engine and the port's take the same submissions: replies
    equal under the tie rule (no flip on this workload), hops, DC,
    degraded flags, reasons and counters equal (the storm on a virtual
    clock, so both see the same deadlines)."""
    clocks = (VClock(), VClock()) if scenario == "storm" else (None, None)
    over = dict(max_wave=8, max_slots=16)
    if scenario == "storm":
        over["default_timeout_s"] = 0.25

    def plan(pkg_plan, clk):
        if clk is None:
            return None
        return pkg_plan(slow_chunk_every=1, slow_chunk_s=0.1,
                        sleep=clk.advance)

    hi = float(wl.attrs.max()) + 1.0
    nv = na = None
    if source == "port_built":
        n = 400 if scenario == "drip" else None
        jidx, tidx = _jax_index(wl, n), _index(wl, n)
        if scenario == "drip":
            nv, na = wl.vectors[400:], np.linspace(hi, hi + 1.0, 100)
        jeng = rl.ServeEngine(index=jidx, now=clocks[0],
                              fault_plan=plan(RefFaultPlan, clocks[0]),
                              config=rl.EngineConfig(**SEARCH, **over))
        teng = ServeEngine(index=tidx, now=clocks[1],
                           fault_plan=plan(EngineFaultPlan, clocks[1]),
                           config=EngineConfig(**SEARCH, **over), device=CPU)
    else:
        rsnap = ref_take_snapshot(_jax_index(wl))
        jeng = rl.ServeEngine(snapshot=rsnap, now=clocks[0],
                              fault_plan=plan(RefFaultPlan, clocks[0]),
                              config=rl.EngineConfig(**SEARCH, **over))
        teng = ServeEngine(snapshot=tds.from_reference(rsnap), now=clocks[1],
                           fault_plan=plan(EngineFaultPlan, clocks[1]),
                           config=EngineConfig(**SEARCH, **over), device=CPU)
    jgot = sorted(_drive(jeng, wl, scenario, nv, na), key=lambda r: r.rid)
    tgot = sorted(_drive(teng, wl, scenario, nv, na), key=lambda r: r.rid)
    assert [r.rid for r in jgot] == [r.rid for r in tgot]

    def res(replies):
        return SearchResult(
            ids=np.stack([np.asarray(r.ids, np.int64) for r in replies]),
            dists=np.stack([np.asarray(r.dists) for r in replies]),
            dc=np.asarray([r.dc for r in replies]),
            hops=np.asarray([r.hops for r in replies]))

    a, b = res(tgot), res(jgot)
    scale = float(2 * (wl.vectors**2).sum(1).max())
    rep = compare_results(a, b, scale=scale)
    assert rep["faults"] == [] and rep["tie_flips"] == [], rep
    np.testing.assert_array_equal(a.hops, b.hops)
    np.testing.assert_array_equal(a.dc, b.dc)
    assert [(r.degraded, r.reason) for r in tgot] == \
        [(r.degraded, r.reason) for r in jgot]
    if scenario == "storm":
        assert any(r.degraded for r in tgot)
        assert [r.finish_t for r in tgot] == [r.finish_t for r in jgot]
    ts, js = teng.stats.summary(), jeng.stats.summary()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    if nv is not None:
        assert len(tidx) == len(jidx) == 500
        assert (tgot[-1].ids >= 400).all()


# ------------------------------------------------------------ the launcher
LAUNCH = ["--n", "1200", "--dim", "16", "--queries", "40", "--width", "32",
          "--m", "8", "--ef-construction", "32", "--engine",
          "--ingest", "200"]


def test_launcher_engine_matches_jax_launcher(capsys, monkeypatch):
    """``launch.serve.main([... "--engine" ...])`` on the CPU: recall
    equals the JAX launcher's engine run (the tie rule allows a flip on
    at most 2% of the queries), and the replies are the JAX
    ``search_batch`` answers over the reference-built index (the burst's
    one wave is assembled before the ingest applies)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    out = serve.main(LAUNCH + ["--device", "cpu"])
    run = out["engine"]
    printed = capsys.readouterr().out
    assert "engine served 40 queries" in printed
    assert run["answered"].all() and not run["degraded"].any()
    assert run["stats"]["ingest"]["rows"] == 200 and len(out["index"]) == 1400
    assert run["captures_after_warmup"] == 0
    monkeypatch.setattr(sys, "argv", ["serve"] + LAUNCH)
    jserve.main()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("engine served")][0]
    jrecall = float(line.rsplit("= ", 1)[1])
    assert abs(run["recall"] - jrecall) <= 0.02

    wl = rc.make_workload(n=1200, d=16, nq=40, seed=0, k=10)
    ri = rc.WoWIndex(dim=16, m=8, ef_construction=32, o=4, seed=0)
    ri.insert_batch(wl.vectors, wl.attrs, batch_size=128)
    rsnap = ref_take_snapshot(ri)
    exp = rds.search_batch(rsnap, wl.queries, wl.ranges, k=10, width=32)
    exp = SearchResult(*(np.asarray(x) for x in exp))
    scale = float(rsnap.sq_norms.max() + (wl.queries**2).sum(1).max())
    rep = compare_results(run["result"], exp, scale=scale)
    assert rep["faults"] == [] and len(rep["tie_flips"]) <= 1, rep


def test_launcher_refusals():
    """One configuration per engine run; the durable branch names A6."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(LAUNCH + ["--device", "cpu", "--backend", "auto", "ref"])
    with pytest.raises(SystemExit):
        serve.main(LAUNCH + ["--device", "cpu", "--compact", "8,8"])
    with pytest.raises(SystemExit):  # no mesh: argparse refuses the flag
        serve.main(LAUNCH + ["--device", "cpu", "--mesh", "2x1"])
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        serve.main(LAUNCH + ["--device", "cpu", "--index-dir", "x"])


def test_launcher_adaptive_filter(capsys):
    """``--visited hash --adaptive-filter``: the post-ingest re-serve runs
    with the filter sized from the first wave's hop counts, as the JAX
    launcher sizes it."""
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--n", "600", "--dim", "16",
                      "--queries", "24", "--width", "32", "--m", "8",
                      "--ef-construction", "32", "--visited", "hash",
                      "--adaptive-filter", "--ingest", "100"])
    (first,), (second,) = out["runs"], out["ingest_runs"]
    assert first["visited_bits"] is None
    want = rds.visited_filter_bits_measured(first["result"].hops, 8)
    assert second["visited_bits"] == want
    assert "adaptive visited filter" in capsys.readouterr().out
    assert second["recall"] >= 0.9


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason (decided per test, never at
    import: every worker must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc: the CUDA kernel cannot be built here")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_engine_matches_kernel_search_batch(cuda_device, wl, idx):
    """On the card: after ``warmup()`` the engine captures no chunk while
    serving, replays graphs of its steady chunks, and its replies equal
    the kernel's one-shot ``search_batch`` bit for bit."""
    snap = take_snapshot(idx)
    ref = search_batch(snap, wl.queries, wl.ranges, k=5, width=32,
                       visited="bitmap", backend="cuda", device="cuda")
    eng = ServeEngine(index=idx, device="cuda", config=EngineConfig(
        **dict(SEARCH, backend="cuda"), max_wave=16))
    eng.warmup()
    captures, replays = tds.GRAPH_CAPTURES["chunks"], dict(tds.GRAPH_REPLAYS)
    tickets, got = [], []
    for i in range(16):
        tickets.append(eng.submit(wl.queries[i], wl.ranges[i]))
    for i in range(16, len(wl.queries)):
        got.extend(eng.step())
        tickets.append(eng.submit(wl.queries[i], wl.ranges[i]))
    got.extend(eng.drain())
    assert tds.GRAPH_CAPTURES["chunks"] == captures
    assert tds.GRAPH_REPLAYS["chunks"] > replays["chunks"]
    replies = {r.rid: r for r in got}
    for i, t in enumerate(tickets):
        r = replies[t.rid]
        assert not r.degraded
        np.testing.assert_array_equal(r.ids, ref.ids[i])
        np.testing.assert_array_equal(r.dists, ref.dists[i])
        assert (r.hops, r.dc) == (ref.hops[i], ref.dc[i])


@pytest.mark.cuda
def test_cuda_engine_max_hops_budget_under_replay(cuda_device, wl, idx):
    """On the card under ``max_hops = 20`` with chunks (4, 8): a wave's
    chunks at t = 4 and t = 12 replay captured graphs (each runs all 8
    hops) and the one at t = 20 runs eagerly to the cap; the harvest reads
    the host-side plan, so every reply equals the kernel's capped one-shot
    ``search_batch`` bit for bit: ids, distances, hops and DC."""
    snap = take_snapshot(idx)
    capped = search_batch(snap, wl.queries, wl.ranges, k=5, width=32,
                          visited="bitmap", backend="cuda", device="cuda",
                          max_hops=20)
    hc = np.asarray(capped.hops)
    assert hc.max() == 20  # the cap bites on this workload
    eng = ServeEngine(index=idx, device="cuda", config=EngineConfig(
        **dict(SEARCH, backend="cuda"), max_wave=16, max_hops=20))
    eng.warmup()
    captures, replays = tds.GRAPH_CAPTURES["chunks"], dict(tds.GRAPH_REPLAYS)
    tickets = [eng.submit(wl.queries[i], wl.ranges[i])
               for i in range(len(wl.queries))]
    replies = {r.rid: r for r in eng.drain()}
    assert tds.GRAPH_CAPTURES["chunks"] == captures
    assert tds.GRAPH_REPLAYS["chunks"] > replays["chunks"]
    for i, t in enumerate(tickets):
        r = replies[t.rid]
        assert not r.degraded
        np.testing.assert_array_equal(r.ids, capped.ids[i])
        np.testing.assert_array_equal(r.dists, capped.dists[i])
        assert (r.hops, r.dc) == (capped.hops[i], capped.dc[i])
