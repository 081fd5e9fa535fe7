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
reference: a cold start over read-only mapped slabs then an ingest, an
acked ingest surviving a crash before its apply, a restart replaying the
pending ingest, a dropped fsync breaking the ack, and SIGKILL with a
pending ingest queue; one durable ingest against the JAX engine's (the
same LSNs, an equal digest after recovery); on the card, a replay through
the device build equal to the live index bit for bit.

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
import repro.persist as rp
from repro.persist import EngineFaultPlan as RefFaultPlan
from repro.serve import lifecycle as rl
from repro_torch.core import WoWIndex, make_workload
from repro_torch.core import device_search as tds
from repro_torch.core.device_search import (
    SearchResult, chunk_schedule_from_hist, compare_results, hist_percentile,
    search_batch,
)
from repro_torch.core.snapshot import take_snapshot
from repro_torch.persist import (
    CrashError, EngineFaultPlan, FaultIO, load_serving_snapshot,
    open_durable, recover, state_digest,
)
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


def test_device_policy_and_durable_branches(tmp_path, wl, idx):
    """``device=None`` is the card (raises without CUDA); an index with a
    write-ahead log acknowledges an ingest by its group commit: every
    micro-batch logged before one fsync, the ack's LSN the last of them,
    the rows durable (recovered) before any apply."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(index=idx)
    root = str(tmp_path)
    io = FaultIO()
    ix = open_durable(root, io=io, create=dict(dim=12, **KW), device=CPU)
    ix.insert_batch(wl.vectors[:100], wl.attrs[:100], batch_size=128)
    assert ix._applied_lsn == 1
    eng = _engine(ix, ingest_batch=30)
    ops = io.ops
    res = eng.submit_ingest(wl.vectors[100:190], wl.attrs[100:190])
    assert res.accepted == 90 and res.pending and res.lsn == 4
    assert io.ops - ops == 4  # three appends, one fsync: the group commit
    assert eng.pending_ingest == 3 and len(ix) == 100
    assert len(recover(root, device=CPU)) == 190  # acked = recoverable
    eng.drain()
    assert ix._applied_lsn == 4 and len(ix) == 190
    assert eng.engine_stats()["applied_lsn"] == 4
    ix._wal.close()


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


# ------------------------------------------------------------ durable ingest
def _durable(root):
    return open_durable(root, create=dict(dim=12, **KW), device=CPU)


def test_cold_start_then_ingest_over_mmap_snapshot(tmp_path, wl):
    """Serve-from-checkpoint hands the engine read-only mapped slabs; the
    first ingest after the cold start refreshes the snapshot with
    ``prev=`` that mapped snapshot.  No consumer may write into the
    mapping or alias it into a tensor (a non-writable-array warning
    fails the test)."""
    import warnings

    root = str(tmp_path)
    ix = _durable(root)
    ix.insert_batch(wl.vectors[:300], wl.attrs[:300], batch_size=128)
    ix.checkpoint(root, incremental=False)
    ix._wal.close()
    del ix
    snap, _ = load_serving_snapshot(root)
    assert not snap.vectors.flags.writeable  # really a read-only mapping
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = ServeEngine(snapshot=snap, config=EngineConfig(**SEARCH),
                          device=CPU)
        eng.submit(wl.queries[0], wl.ranges[0])
        (r0,) = eng.drain()
        assert not r0.degraded
        ix2 = open_durable(root, device=CPU)
        eng2 = ServeEngine(index=ix2, snapshot=snap, device=CPU,
                           config=EngineConfig(**SEARCH, ingest_batch=50,
                                               build_backend="numpy"))
        hi = float(wl.attrs.max()) + 1.0
        nv, na = wl.vectors[300:350], np.linspace(hi, hi + 1.0, 50)
        assert eng2.submit_ingest(nv, na).accepted == 50
        eng2.drain()
        t = eng2.submit(nv[0], (hi, hi + 1.0))
        (r,) = eng2.drain()
    assert r.rid == t.rid and (r.ids >= 300).all()
    assert r.dists[0] <= 1e-3  # the ingested rows are really served
    ix2._wal.close()


def _want(wl, spans, bs=50):
    want = WoWIndex(dim=12, device=CPU, **KW)
    for lo, hi in spans:
        for s in range(lo, hi, bs):
            want.insert_batch(wl.vectors[s:min(s + bs, hi)],
                              wl.attrs[s:min(s + bs, hi)], batch_size=bs)
    return want


def test_ingest_ack_survives_crash_before_apply(tmp_path, wl):
    """Batches acked by ``submit_ingest`` but never applied (a crash in
    the middle of the queue) are recovered from the log; the recovered
    engine counts them as replayed."""
    root = str(tmp_path)
    ix = _durable(root)
    ix.insert_batch(wl.vectors[:100], wl.attrs[:100], batch_size=50)
    plan = EngineFaultPlan(crash_after_ingest_applies=1)
    eng = ServeEngine(index=ix, fault_plan=plan, device=CPU,
                      config=EngineConfig(**SEARCH, ingest_batch=50,
                                          build_backend="numpy"))
    res = eng.submit_ingest(wl.vectors[100:250], wl.attrs[100:250])
    assert res.accepted == 150 and eng.pending_ingest == 3
    with pytest.raises(CrashError):
        eng.drain()  # applies batch 1, dies entering batch 2
    assert eng.pending_ingest == 2
    rec = recover(root, device=CPU)
    assert state_digest(rec) == state_digest(_want(wl, [(0, 250)]))
    assert rec._replayed_rows == 250
    assert ServeEngine(index=rec, device=CPU).stats.ingest_replayed == 250


def test_restart_replays_pending_ingest(tmp_path, wl):
    """A restarted server sees every acked-but-unapplied micro-batch."""
    root = str(tmp_path)
    ix = _durable(root)
    eng = ServeEngine(index=ix, device=CPU, config=EngineConfig(
        **SEARCH, ingest_batch=40, build_backend="numpy"))
    eng.submit_ingest(wl.vectors[:120], wl.attrs[:120])
    assert eng.pending_ingest == 3 and len(ix) == 0
    del eng, ix  # "restart" without ever driving the scheduler
    ix2 = open_durable(root, device=CPU)
    assert len(ix2) == 120
    eng2 = _engine(ix2)
    t = eng2.submit(wl.vectors[0], (float(wl.attrs.min()),
                                    float(wl.attrs.max())))
    (r,) = eng2.drain()
    assert r.rid == t.rid and r.dists[0] <= 1e-3
    assert eng2.stats.ingest_replayed == 120


def test_dropped_fsync_breaks_the_ack(tmp_path, wl):
    """With fsyncs dropped a post-ack crash loses the "acked" batches: the
    ack's durability comes from the group commit's fsync."""
    root = str(tmp_path)
    ix = _durable(root)
    ix.insert_batch(wl.vectors[:60], wl.attrs[:60], batch_size=30)
    ix.checkpoint(root)
    del ix
    io = FaultIO(drop_fsync=True, model="lost")
    ix = open_durable(root, io=io, device=CPU)
    eng = ServeEngine(index=ix, device=CPU, config=EngineConfig(
        **SEARCH, ingest_batch=30, build_backend="numpy"))
    assert eng.submit_ingest(wl.vectors[60:120],
                             wl.attrs[60:120]).accepted == 60
    with pytest.raises(CrashError):
        io._crash()
    assert len(recover(root, device=CPU)) == 60


def test_sigkill_with_pending_ingest_queue(tmp_path):
    """A real SIGKILL of a process serving the port with acked batches in
    the ingest queue (two applied, four only logged): recovery builds the
    index a clean application of every acked batch builds."""
    import signal
    import subprocess

    root = str(tmp_path)
    child = f"""
import os, signal
from repro_torch.core import make_workload
from repro_torch.persist import open_durable
from repro_torch.serve.lifecycle import ServeEngine, EngineConfig
wl = make_workload(n=300, d=12, nq=1, seed=7, with_gt=False)
idx = open_durable({root!r}, create=dict(dim=12, m=8, ef_construction=32,
                                         o=4, seed=0), device="cpu")
eng = ServeEngine(index=idx, device="cpu", config=EngineConfig(
    k=5, width=32, ingest_batch=50, build_backend="numpy"))
for i in range(6):
    r = eng.submit_ingest(wl.vectors[50*i:50*(i+1)], wl.attrs[50*i:50*(i+1)])
    assert r.accepted == 50 and r.pending and r.lsn == i + 1
    print("ACK", i, flush=True)
eng.step(); eng.step()
print("PENDING", eng.pending_ingest, flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == -signal.SIGKILL, res.stderr
    assert res.stdout.count("ACK") == 6 and "PENDING 4" in res.stdout
    wl7 = make_workload(n=300, d=12, nq=1, seed=7, with_gt=False)
    assert state_digest(recover(root, device=CPU)) == \
        state_digest(_want(wl7, [(0, 300)]))


def test_durable_ingest_matches_jax_engine(tmp_path, wl):
    """One durable ingest through both engines over equal host-built
    indexes: the same acks (LSNs), byte-equal logs, and an equal digest
    after each package recovers its own directory and the other's."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    create = dict(dim=12, **KW)
    jix = rp.open_durable(jroot, create=create)
    tix = open_durable(troot, create=create, device=CPU)
    for ix in (jix, tix):
        ix.insert_batch(wl.vectors[:200], wl.attrs[:200], batch_size=100)
    cfg = dict(SEARCH, ingest_batch=40, build_backend="numpy")
    jeng = rl.ServeEngine(index=jix, config=rl.EngineConfig(**cfg))
    teng = ServeEngine(index=tix, config=EngineConfig(**cfg), device=CPU)
    bad = wl.vectors[200:330].copy()
    bad[7, 0] = np.nan  # one rejected row, in both
    acks = [(e.submit_ingest(bad, wl.attrs[200:330]),
             e.submit_ingest(wl.vectors[330:400], wl.attrs[330:400]))
            for e in (jeng, teng)]
    for a, b in zip(*acks):
        assert (a.accepted, a.lsn, a.rejected) == (b.accepted, b.lsn,
                                                   b.rejected)
    assert [r.lsn for r in acks[1]] == [6, 8]
    jeng.drain()
    teng.drain()
    assert jix._applied_lsn == tix._applied_lsn == 8
    for ix in (jix, tix):
        ix._wal.close()
    with open(os.path.join(jroot, "wal", "wal-00000000.seg"), "rb") as f:
        jbytes = f.read()
    with open(os.path.join(troot, "wal", "wal-00000000.seg"), "rb") as f:
        assert f.read() == jbytes
    want = rp.state_digest(jix)
    assert state_digest(tix) == want
    for root in (jroot, troot):
        assert state_digest(recover(root, device=CPU)) == want
        assert rp.state_digest(rp.recover(root)) == want


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


def test_launcher_refusals(tmp_path, capsys, monkeypatch):
    """One configuration per engine run.  ``--index-dir``: the first run
    builds with a logged ingest and checkpoints, the second cold-starts
    off the checkpoint and serves the same replies bit for bit; the
    checkpoint has the digest of the JAX launcher's, whose cold start
    prints the same recall."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(LAUNCH + ["--device", "cpu", "--backend", "auto", "ref"])
    with pytest.raises(SystemExit):
        serve.main(LAUNCH + ["--device", "cpu", "--compact", "8,8"])
    with pytest.raises(SystemExit):  # no mesh: argparse refuses the flag
        serve.main(LAUNCH + ["--device", "cpu", "--mesh", "2x1"])
    args = ["--n", "1200", "--dim", "16", "--queries", "40", "--width", "32",
            "--m", "8", "--ef-construction", "32", "--compact-rows"]
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    built = serve.main(args + ["--device", "cpu", "--index-dir", troot])
    assert built["cold_start"] is None and built["index"]._applied_lsn > 0
    cold = serve.main(args + ["--device", "cpu", "--index-dir", troot])
    assert cold["index"] is None and cold["cold_start"]["first_reply_s"] > 0
    for a, b in zip(built["runs"][0]["result"], cold["runs"][0]["result"]):
        np.testing.assert_array_equal(a, b)
    printed = capsys.readouterr().out
    assert "cold start from" in printed and "cold-start-to-first-query" \
        in printed
    jout = []
    for _ in range(2):
        monkeypatch.setattr(sys, "argv", ["serve"] + args + [
            "--index-dir", jroot])
        jserve.main()
        jout.append(capsys.readouterr().out)
    assert "cold start from" not in jout[0] and "cold start from" in jout[1]
    assert state_digest(recover(troot, device=CPU)) == \
        rp.state_digest(rp.recover(jroot))
    line = [ln for ln in jout[1].splitlines()
            if ln.startswith("served 40 queries")][0]
    jrecall = float(line.split("= ", 1)[1].split(",")[0])
    assert cold["runs"][0]["recall"] == pytest.approx(jrecall, abs=1e-4)


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


@pytest.mark.cuda
def test_cuda_replay_equals_live_index(cuda_device, tmp_path, wl):
    """On the card: an index that ingests through the engine with the
    device build (its delta-maintained arena, a compaction in between)
    and the index recovered from its checkpoint and log (a fresh arena,
    the records replayed through the device build) are equal bit for
    bit, and so are their replies through the kernel."""
    root = str(tmp_path)
    ix = open_durable(root, create=dict(dim=12, **KW), device="cuda")
    ix.insert_batch(wl.vectors[:200], wl.attrs[:200], batch_size=100,
                    backend="device")
    ix.checkpoint(root)
    eng = ServeEngine(index=ix, device="cuda", config=EngineConfig(
        **dict(SEARCH, backend="cuda"), ingest_batch=50,
        build_backend="device"))
    eng.submit_ingest(wl.vectors[200:300], wl.attrs[200:300])
    for i in range(8):
        eng.submit(wl.queries[i], wl.ranges[i])
    eng.drain()
    ix.delete(3)
    ix.compact_rows()
    eng.submit_ingest(wl.vectors[300:400], wl.attrs[300:400])
    eng.drain()
    ix._wal.close()
    rec = recover(root)  # device None: the card
    assert rec._replayed_rows == 200 and len(rec) == len(ix) == 399
    assert state_digest(rec) == state_digest(ix)
    got = [search_batch(take_snapshot(x), wl.queries, wl.ranges, k=5,
                        width=32, backend="cuda", device="cuda")
           for x in (ix, rec)]
    for a, b in zip(*got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
