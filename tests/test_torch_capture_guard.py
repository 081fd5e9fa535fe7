"""The port's runtime capture guard (``repro_torch.analysis.
compile_guard.CaptureCounter``) and the shape-stable-ingest gate it holds
the serve engine to, the port of ``tests/test_analysis.py``'s compile-
guard cases.  This file imports no JAX: its CUDA cases run on the card.

On the CPU: the counter counts the events the capture and build sites
report while it is active (and only then), under concurrent reporters;
a kernel library's uncached load is counted once and then cached; the
launcher's ``--trace-compiles`` runs.  On the card: a hop chunk is
counted at its capture and never again at its replays, and the
reference's gate scenario (n 520, d 12: warm up, serve a wave, ingest 120
rows within the pow2 capacities, serve again) captures and builds
nothing after ``warmup()``, its replies bitwise the kernel's
``search_batch`` on each wave's snapshot.
"""
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import monitoring
from repro_torch.analysis import CaptureCounter, trace_compiles
from repro_torch.core import WoWIndex, make_workload
from repro_torch.core.device_search import search_batch
from repro_torch.core.snapshot import take_snapshot
from repro_torch.kernels import _build
from repro_torch.serve.lifecycle import EngineConfig, ServeEngine


def test_counter_counts_events_while_active():
    monitoring.record_event("capture", "before", 0.5)
    with CaptureCounter() as outer:
        monitoring.record_event("capture", "chunk", 0.25)
        with CaptureCounter("inner") as inner:
            monitoring.record_event("build", "k", 1.0)
        monitoring.record_event("load", "k", 0.125)
    monitoring.record_event("capture", "after", 0.5)
    assert outer.count == 3 and inner.count == 1
    assert outer.by_kind == {"capture": 1, "build": 1, "load": 1}
    assert outer.total_secs == pytest.approx(1.375)
    assert [e[1] for e in outer.events] == ["chunk", "k", "k"]


def test_trace_compiles_prints_each_event(capsys):
    with trace_compiles("serve"):
        monitoring.record_event("capture", "hop chunk h=8 B=64", 0.01)
    err = capsys.readouterr().err
    assert "[wowlint] [serve] capture #1: hop chunk h=8 B=64" in err


def test_counter_under_concurrent_reporters():
    """Reporters on many threads, counters entered and left meanwhile:
    no event of an active counter is lost."""
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with CaptureCounter() as total:
            start = threading.Barrier(n_threads + 1)

            def report():
                start.wait(timeout=30)
                for i in range(per):
                    monitoring.record_event("capture", f"c{i}", 0.0)

            threads = [threading.Thread(target=report)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            start.wait(timeout=30)
            for _ in range(50):  # churn the active set
                with CaptureCounter():
                    pass
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert total.count == n_threads * per
    assert len(total.events) == n_threads * per


def test_library_load_counted_once_then_cached(monkeypatch, tmp_path):
    """An uncached ``_build.load`` reports one ``load`` event; the next
    call is served from the cache and reports nothing (the build itself
    needs nvcc: the source counts as built here)."""

    class FakeLib:
        def __init__(self, path):
            self.gather_norm_dot = lambda *a: 0

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_start", lambda name: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    with CaptureCounter() as cold:
        _build.load("gather_norm_dot")
    with CaptureCounter() as warm:
        _build.load("gather_norm_dot")
    assert cold.by_kind == {"load": 1} and warm.count == 0


def test_launcher_trace_compiles_on_cpu(capsys):
    """``--trace-compiles`` runs the launcher under the tracer; the CPU
    path captures and builds nothing, so it prints no event."""
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--n", "300", "--dim", "8",
                      "--queries", "8", "--m", "8", "--ef-construction",
                      "16", "--trace-compiles"])
    assert out["runs"]
    assert "[wowlint]" not in capsys.readouterr().err


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason (decided per test, never at
    import: every worker must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs and the kernels run only "
                    "on the card")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc: the CUDA kernel cannot be built here")
    return torch.device("cuda")


@pytest.mark.cuda
def test_capture_counted_once_then_replayed(cuda_device):
    """The compile-smoke: a hop chunk's capture is counted when it is
    captured and never at its replays."""
    from repro_torch.analysis.__main__ import _compile_smoke

    assert _compile_smoke() == 0


@pytest.mark.cuda
def test_zero_captures_after_warmup_across_ingest_growth(cuda_device):
    """The shape-stable-ingest gate: after ``warmup()``, serving a wave,
    growing the index by an ingest batch within the pow2 capacities and
    serving the refreshed snapshot captures and builds NOTHING — the
    refresh writes into the serving set the graphs were captured on."""
    wl = make_workload(n=520, d=12, nq=16, seed=3, k=5, with_gt=False)
    idx = WoWIndex(dim=12, m=12, ef_construction=48, o=4, seed=0)
    idx.insert_batch(wl.vectors, wl.attrs, batch_size=128, backend="numpy")
    cfg = EngineConfig(k=5, width=16, max_wave=8, adaptive=False,
                       visited="bitmap", build_backend="numpy",
                       backend="cuda")
    eng = ServeEngine(index=idx, config=cfg, device="cuda")
    eng.warmup()

    def serve_wave(base):
        snap = take_snapshot(idx)
        tickets = [eng.submit(wl.queries[base + i], wl.ranges[base + i])
                   for i in range(8)]
        replies = {r.rid: r for r in eng.drain()}
        assert len(replies) == 8
        return snap, tickets, replies

    with CaptureCounter("post-warmup") as cc:
        waves = [serve_wave(0)]
        rng = np.random.default_rng(11)
        extra_v = rng.normal(size=(120, 12)).astype(np.float32)
        extra_a = np.arange(120) / 120.0 + float(np.max(wl.attrs)) + 1.0
        assert eng.submit_ingest(extra_v, extra_a).accepted == 120
        eng.drain()  # applies the ingest micro-batch
        assert len(idx) == 520 + 120
        waves.append(serve_wave(8))  # on the refreshed snapshot
        torch.cuda.synchronize()
    assert cc.count == 0, (
        f"{cc.count} capture(s)/build(s) after warmup: {cc.events}")
    for base, (snap, tickets, replies) in zip((0, 8), waves):
        want = search_batch(snap, wl.queries[base:base + 8],
                            wl.ranges[base:base + 8], k=5, width=16,
                            visited="bitmap", backend="cuda", device="cuda")
        for i, t in enumerate(tickets):
            r = replies[t.rid]
            ids = np.where(want.ids[i] >= 0,
                           snap.ids_map[np.clip(want.ids[i], 0, None)], -1)
            np.testing.assert_array_equal(r.ids, ids)
            np.testing.assert_array_equal(r.dists, want.dists[i])
            assert (r.hops, r.dc) == (want.hops[i], want.dc[i])
