"""The port's span recorder and counters (``repro_torch.monitoring``) on the
CPU: spans nest by thread and share their wave's id, tracing off records
nothing and touches no profiler, a span is a profiler range only inside a
profiler session, ``counters()`` reads the modules' own counters, and the
serve engine's spans appear in their nesting without changing a reply."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import monitoring
from repro_torch.core import device_search, snapshot
from repro_torch.core.index import WoWIndex
from repro_torch.kernels import gather_distance
from repro_torch.serve.lifecycle import EngineConfig, ServeEngine

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_records():
    monitoring.clear()
    yield
    monitoring.clear()


def _path(recs, i) -> str:
    """``a > b > c``: the names from the outermost span down to ``i``,
    without the ``repro_torch.`` prefix."""
    names = []
    while i is not None:
        names.append(recs[i]["name"].removeprefix("repro_torch."))
        i = recs[i]["parent"]
    return " > ".join(reversed(names))


# ----------------------------------------------------------------- recorder
def test_spans_nest_by_parent_and_share_ids():
    with monitoring.tracing():
        with monitoring.span("repro_torch.engine.step"):
            with monitoring.span("repro_torch.engine.chunk", id=7, h=8) as sp:
                with monitoring.span("repro_torch.chunk.hops", id=7):
                    pass
                sp.set(replies=3)
            with monitoring.span("repro_torch.engine.assemble", id=8):
                pass
        with monitoring.span("repro_torch.engine.submit", id=1):
            pass
    recs = monitoring.spans()
    assert [_path(recs, i) for i in range(len(recs))] == [
        "engine.step", "engine.step > engine.chunk",
        "engine.step > engine.chunk > chunk.hops",
        "engine.step > engine.assemble", "engine.submit"]
    assert [r["parent"] for r in recs] == [None, 0, 1, 0, None]
    assert [r["id"] for r in recs] == [None, 7, 7, 8, 1]
    assert recs[1]["attrs"] == {"h": 8, "replies": 3}
    for r in recs:
        assert r["t0"] <= r["t1"]
    step, chunk, hops = recs[:3]
    assert step["t0"] <= chunk["t0"] <= hops["t0"] <= hops["t1"] \
        <= chunk["t1"] <= step["t1"]


def test_spans_parent_on_their_own_thread():
    """Many threads, switched often: every record is kept, and each inner
    span's parent is its own thread's outer span."""
    threads, pairs = 16, 50

    def work(tag):
        for _ in range(pairs):
            with monitoring.span("repro_torch.t.outer", id=tag):
                with monitoring.span("repro_torch.t.inner", id=tag):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with monitoring.tracing():
            ts = [threading.Thread(target=work, args=(t,))
                  for t in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    recs = monitoring.spans()
    assert len(recs) == 2 * threads * pairs
    for r in recs:
        if r["name"] == "repro_torch.t.inner":
            parent = recs[r["parent"]]
            assert parent["name"] == "repro_torch.t.outer"
            assert parent["id"] == r["id"] and parent["t0"] <= r["t0"]
        else:
            assert r["parent"] is None


def test_tracing_off_is_the_shared_no_op(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not monitoring.enabled()
    sp = monitoring.span("repro_torch.engine.step", id=3, rows=4)
    assert sp is monitoring.NO_SPAN
    assert monitoring.span("repro_torch.chunk.hops") is sp
    with sp as inner:
        inner.set(replies=2)
        assert inner is monitoring.NO_SPAN
    assert monitoring.spans() == [] and opened == []
    with monitoring.tracing():
        assert monitoring.enabled()
        with monitoring.tracing(False):  # off inside on, then back
            with monitoring.span("repro_torch.engine.expire"):
                pass
        with monitoring.span("repro_torch.engine.step"):
            pass  # recorded; no profiler session, so no range
        assert opened == []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with monitoring.span("repro_torch.engine.chunk"):
                pass
    assert not monitoring.enabled()
    assert [r["name"] for r in monitoring.spans()] == \
        ["repro_torch.engine.step", "repro_torch.engine.chunk"]
    assert opened == ["repro_torch.engine.chunk"]
    assert "repro_torch.engine.chunk" in {e.name for e in prof.events()}


def test_counters_read_the_modules_own_counts(monkeypatch):
    c = monitoring.counters()
    for name, counts in (("GRAPH_REPLAYS", device_search.GRAPH_REPLAYS),
                         ("GRAPH_CAPTURES", device_search.GRAPH_CAPTURES),
                         ("KERNEL_REPLAYS", device_search.KERNEL_REPLAYS),
                         ("EAGER_CHUNKS", device_search.EAGER_CHUNKS)):
        for k, v in counts.items():
            assert c[f"device_search.{name}.{k}"] == v
    assert set(device_search.EAGER_CHUNKS) == {"seed", "first", "cap",
                                               "off_card"}
    assert c["kernels.LAUNCHES.gather_norm_dot"] == \
        gather_distance.LAUNCHES["gather_norm_dot"]
    for k in ("full_uploads", "rows_appended", "rows_scattered"):
        assert f"snapshot.DeviceBuildArena.{k}" in c
    assert {"lifecycle.ServeEngine.refreshes",
            "lifecycle.ServeEngine.serving_set_copies"} <= set(c)
    # read where they live, not copied: a count moved by its module shows
    monkeypatch.setitem(device_search.GRAPH_REPLAYS, "chunks",
                        device_search.GRAPH_REPLAYS["chunks"] + 5)
    monkeypatch.setitem(gather_distance.LAUNCHES, "gather_norm_dot",
                        gather_distance.LAUNCHES["gather_norm_dot"] + 2)
    c2 = monitoring.counters()
    assert c2["device_search.GRAPH_REPLAYS.chunks"] == \
        c["device_search.GRAPH_REPLAYS.chunks"] + 5
    assert c2["kernels.LAUNCHES.gather_norm_dot"] == \
        c["kernels.LAUNCHES.gather_norm_dot"] + 2
    arena = snapshot.DeviceBuildArena(device=CPU)  # a live arena counts
    arena.stats["rows_appended"] += 9
    assert monitoring.counters()["snapshot.DeviceBuildArena.rows_appended"] \
        == c["snapshot.DeviceBuildArena.rows_appended"] + 9
    del arena


# ------------------------------------------------------------------- engine
N, D = 240, 8
ROWS = 32  # one ingest micro-batch


def _data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N + ROWS, D)).astype(np.float32)
    a = rng.random(N + ROWS)
    q = rng.standard_normal((24, D)).astype(np.float32)
    lo = rng.random(24) * 0.5
    return x, a, q, np.stack([lo, lo + 0.5], axis=1)


def _engine():
    x, a, _, _ = _data()
    idx = WoWIndex(dim=D, m=8, ef_construction=24, o=4, seed=3, device=CPU)
    idx.insert_batch(x[:N], a[:N], batch_size=80, backend="device")
    return ServeEngine(index=idx, config=EngineConfig(
        k=5, width=16, max_wave=16, max_slots=32, chunk=(4, 4),
        adaptive=False, ingest_batch=ROWS, build_backend="device"),
        device=CPU)


def _serve(traced: bool, ingest: bool):
    x, a, q, r = _data()
    eng = _engine()
    eng.warmup()
    monitoring.clear()
    with monitoring.tracing(traced):
        if ingest:
            eng.submit_ingest(x[N:], a[N:] + 1.0)  # attributes past the base
        for i in range(len(q)):
            eng.submit(q[i], r[i])
        replies = sorted(eng.drain(), key=lambda p: p.rid)
    return replies, monitoring.spans(), eng


@pytest.mark.parametrize("ingest", [False, True], ids=["read", "ingest"])
def test_engine_spans_nest_and_leave_replies_bitwise(ingest):
    plain, none, _ = _serve(False, ingest)
    assert none == []
    got, recs, eng = _serve(True, ingest)
    assert len(got) == len(plain) == 24
    for a, b in zip(got, plain):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        assert (a.hops, a.dc, a.degraded) == (b.hops, b.dc, b.degraded)
    paths = {_path(recs, i) for i in range(len(recs))}
    assert {"engine.submit", "engine.step", "engine.step > engine.assemble",
            "engine.step > engine.chunk",
            "engine.step > engine.chunk > chunk.hops",
            "engine.step > engine.chunk > chunk.sync",
            "engine.step > engine.chunk > chunk.harvest"} <= paths
    for r in recs:
        assert r["t1"] is not None and r["t0"] <= r["t1"]
    # a wave's spans share its id, and every request waited a time >= 0
    assembled = [r for r in recs if r["name"] == "repro_torch.engine.assemble"]
    assert sum(r["attrs"]["rows"] for r in assembled) == 24
    assert all((r["attrs"]["waits_s"] >= 0).all()
               and len(r["attrs"]["waits_s"]) == r["attrs"]["rows"]
               for r in assembled)
    waves = {r["id"] for r in assembled}
    chunks = [r for r in recs if r["name"] == "repro_torch.engine.chunk"]
    assert {r["id"] for r in chunks} == waves == set(range(len(waves)))
    for r in recs:
        if r["name"] in ("repro_torch.chunk.harvest", "repro_torch.chunk.sync"):
            parent = recs[r["parent"]]
            assert parent["name"] == "repro_torch.engine.chunk"
            if r["name"] == "repro_torch.chunk.harvest":
                assert r["id"] == parent["id"]
        if r["name"] == "repro_torch.chunk.hops":  # a wave's or a build's
            assert recs[r["parent"]]["name"] in ("repro_torch.engine.chunk",
                                                 "repro_torch.build.phase1")
    hops = [r for r in recs if r["name"] == "repro_torch.chunk.hops"]
    assert {r["attrs"]["mode"] for r in hops} == {"eager_off_card"}
    if not ingest:
        assert not any(p.startswith("engine.step > engine.ingest_apply")
                       for p in paths)
        return
    assert {"engine.submit_ingest",
            "engine.step > engine.ingest_apply",
            "engine.step > engine.ingest_apply > build.phase1",
            "engine.step > engine.ingest_apply > build.phase1 > chunk.hops",
            "engine.step > engine.ingest_apply > build.phase2",
            "engine.step > engine.ingest_apply > build.commit",
            "engine.step > engine.refresh",
            "engine.step > engine.refresh > snapshot.take",
            "engine.step > engine.refresh > snapshot.upload"} <= paths
    (apply,) = [r for r in recs if r["name"] ==
                "repro_torch.engine.ingest_apply"]
    assert apply["id"] == 0 and apply["attrs"]["rows"] == ROWS
    phases = [r for r in recs if r["name"].startswith("repro_torch.build.")]
    assert [r["name"].rsplit(".", 1)[1] for r in phases] == \
        ["phase1", "phase2", "commit"]
    assert all(r["attrs"]["rows"] == ROWS for r in phases)
    (take,) = [r for r in recs if r["name"] == "repro_torch.snapshot.take"]
    assert take["attrs"]["mode"] in ("full", "incremental")
    assert eng.stats.refreshes == 2  # warmup's first snapshot, then one
    assert len(eng.index) == N + ROWS


def test_counters_count_with_tracing_off():
    x, a, q, r = _data()
    eng = _engine()
    eng.warmup()
    c0 = monitoring.counters()
    eng.submit_ingest(x[N:], a[N:] + 1.0)
    for i in range(len(q)):  # a second wave, assembled after the apply
        eng.submit(q[i], r[i])
    eng.drain()
    c1 = monitoring.counters()
    d = {k: c1[k] - c0.get(k, 0) for k in c1}
    assert monitoring.spans() == []
    assert d["device_search.EAGER_CHUNKS.off_card"] >= eng.stats.chunks > 0
    assert d["lifecycle.ServeEngine.refreshes"] == 1
    assert d["snapshot.DeviceBuildArena.rows_appended"] == ROWS
