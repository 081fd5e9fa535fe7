"""``wowbench.stages``: the device-idle time of a synthetic trace by the
program ranges open on the host, and the stage quantities on synthetic
spans and counters (CPU; no profiler runs)."""
import numpy as np
import pytest

from wowbench import stages, tracing

P = "repro_torch."


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def synthetic():
    """A 1,000 us slice with the device busy at 100-300 and 500-600; the
    engine's step at 50-850 holds a chunk's hops (100-400) and its sync
    (400-520); a submit at 870-900.  The benchmark's own range, the
    device-side copy of a range and a range ending before the slice do
    not count."""
    return [
        ev("spin_kernel", -500, 400),
        ev(tracing.SLICE, 0, 1000, cat="user_annotation"),
        ev(P + "engine.submit", -300, 100, cat="user_annotation"),
        ev("wowbench.step", 40, 820, cat="user_annotation"),
        ev(P + "engine.step", 50, 800, cat="user_annotation"),
        ev(P + "chunk.hops", 100, 300, cat="user_annotation"),
        ev(P + "chunk.hops", 100, 300, cat="gpu_user_annotation"),
        ev(P + "chunk.sync", 400, 120, cat="user_annotation"),
        ev(P + "engine.submit", 870, 30, cat="user_annotation"),
        ev("aten::nonzero", 310, 180, cat="cpu_op"),
        ev("sort_kernel", 100, 150),
        ev("sort_kernel", 200, 100),
        ev("void gather_norm_dot_kernel<float>", 500, 100),
    ]


STEP, HOPS, SYNC, SUBMIT = (P + "engine.step", P + "chunk.hops",
                            P + "chunk.sync", P + "engine.submit")


def idle(events=None, spans=None):
    return stages.idle_stacks(stages.trace_intervals(
        synthetic() if events is None else events), spans)


def test_idle_stacks_split_exactly_at_range_ends():
    got = idle()
    want = {(): 170e-6,  # 0-50, 850-870, 900-1000
            (STEP,): 300e-6,  # 50-100, 600-850
            (STEP, HOPS): 100e-6,  # 300-400
            (STEP, SYNC): 100e-6,  # 400-500 (busy from 500)
            (SUBMIT,): 30e-6}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12)


def test_idle_by_span_sums_to_the_slice_idle_time():
    events = synthetic()
    s = tracing.summary(events)
    by = stages.idle_by_span(idle(events))
    assert by[stages.OUTSIDE] == pytest.approx(170e-6)
    assert by[STEP] == pytest.approx(300e-6)
    assert sum(by.values()) == pytest.approx(s["window_s"] - s["busy_s"],
                                             abs=1e-12)
    # the summary's own keys are untouched by the stage reader
    assert set(s) == {"window_s", "busy_s", "device_s", "device_ops",
                      "idle_gaps", "prelude_kept"}


def test_idle_stacks_with_no_program_range_is_all_outside():
    events = [e for e in synthetic() if not e["name"].startswith(P)]
    assert idle(events) == {(): pytest.approx(700e-6)}
    with pytest.raises(tracing.TraceError):
        stages.trace_intervals([e for e in events
                                if e["name"] != tracing.SLICE])


def rec(name, t0, t1, **attrs):
    return {"name": P + name, "t0": t0, "t1": t1, "parent": None,
            "id": None, "attrs": attrs}


def test_quantities_of_a_read_window():
    spans = [rec("engine.assemble", 0.0, 0.001,
                 waits_s=np.linspace(0.0, 0.099, 100)),
             rec("engine.assemble", 0.5, 0.501, waits_s=np.full(100, 0.2)),
             rec("engine.chunk", 0.1, 0.2)]
    counters = {"device_search.EAGER_CHUNKS.seed": 3,
                "device_search.EAGER_CHUNKS.first": 1,
                "device_search.GRAPH_REPLAYS.chunks": 36}
    stacks = idle()
    q = stages.quantities(spans, counters, 40, stacks, 1000e-6)
    waits = np.concatenate([np.linspace(0.0, 0.099, 100), np.full(100, 0.2)])
    assert q["engine.queue_wait_p95_ms"] == pytest.approx(
        np.percentile(waits, 95) * 1e3)
    assert q["search.eager_chunk_share"] == pytest.approx(10.0)  # 4 of 40
    # idle with an engine or chunk range open: 300 + 100 + 100 + 30 us
    assert q["engine.idle_share"] == pytest.approx(53.0)
    assert q["engine.idle_share"] <= 100 * (1 - 300e-6 / 1000e-6)
    assert q["ingest.apply_idle_share"] is None  # no apply in the window
    assert q["ingest.apply_ms"] is None and q["ingest.refresh_ms"] is None


def test_quantities_of_an_ingest_window():
    spans = [rec("engine.ingest_apply", 0.0, 0.30),
             rec("build.phase1", 0.0, 0.20),
             rec("engine.ingest_apply", 1.0, 1.25),
             rec("engine.ingest_apply", 2.0, 2.40),
             rec("engine.refresh", 0.31, 0.33),
             rec("engine.refresh", 1.3, 1.36),
             rec("engine.step", 3.0, None)]  # open at the close: not timed
    stacks = {(): 0.5, (P + "engine.step",): 0.1,
              (P + "engine.step", P + "engine.ingest_apply"): 0.2,
              (P + "engine.step", P + "engine.ingest_apply",
               P + "build.phase1", P + "chunk.hops"): 0.7,
              (P + "engine.step", P + "engine.refresh",
               P + "snapshot.take"): 0.3}
    q = stages.quantities(spans, {}, 0, stacks, 2.0)
    assert q["ingest.apply_ms"] == pytest.approx(300.0)
    assert q["ingest.refresh_ms"] == pytest.approx(40.0)
    # under an apply or a refresh at any depth: 0.2 + 0.7 + 0.3 s of 2 s
    assert q["ingest.apply_idle_share"] == pytest.approx(60.0)
    assert q["engine.idle_share"] == pytest.approx(65.0)
    assert q["search.eager_chunk_share"] is None  # no chunk ran
    assert q["engine.queue_wait_p95_ms"] is None
    assert stages._span_totals(spans)[P + "engine.ingest_apply"] == \
        [3, pytest.approx(0.95)]


def test_ranges_take_their_spans_modes_where_the_records_match():
    # the window's records: an earlier chunk, then the slice's five ranges
    spans = [rec("engine.step", 0, 1), rec("chunk.hops", 0, 1, mode="replay"),
             rec("engine.submit", 0, 1), rec("engine.step", 2, 3),
             rec("chunk.hops", 2, 3, mode="eager_seed"),
             rec("chunk.sync", 3, 4), rec("engine.submit", 4, 5)]
    got = idle(spans=spans)
    assert got[(STEP, HOPS + "[eager_seed]")] == pytest.approx(100e-6)
    assert got[(STEP, SYNC)] == pytest.approx(100e-6)
    by = stages.idle_by_span(got)
    assert HOPS not in by and by[HOPS + "[eager_seed]"] == pytest.approx(100e-6)
    # records that are not the trace's ranges leave the names bare
    bare = idle(spans=spans[:3])
    assert bare == idle()
    totals = stages._span_totals(spans)
    assert totals[HOPS] == [2, 2] and totals[HOPS + "[replay]"] == [1, 1]


def test_longest_gaps_by_the_stages_they_span():
    trace = stages.trace_intervals(synthetic())
    gaps = stages.longest_gaps(trace)
    assert [g[0] for g in gaps] == pytest.approx([400e-6, 200e-6, 100e-6])
    assert gaps[0][1] == {STEP: pytest.approx(250e-6),  # 600-1000
                          stages.OUTSIDE: pytest.approx(120e-6),
                          SUBMIT: pytest.approx(30e-6)}
    assert gaps[1][1] == {HOPS: pytest.approx(100e-6),
                          SYNC: pytest.approx(100e-6)}
    assert stages.longest_gaps(trace, top=1) == gaps[:1]


def test_trace_intervals_take_the_summarys_own_busy_intervals():
    events = synthetic()
    union = tracing._union
    trace = stages.trace_intervals(events)
    assert trace["summary"] == tracing.summary(events)
    assert (trace["t0"], trace["t1"]) == (0.0, 1000.0)
    assert trace["busy"] == [(100.0, 300.0), (500.0, 600.0)]
    assert sum(b - a for a, b in trace["busy"]) / 1e6 == pytest.approx(
        trace["summary"]["busy_s"], abs=1e-15)
    assert [r[2] for r in trace["ranges"]] == [SUBMIT, STEP, HOPS, SYNC,
                                               SUBMIT]
    assert tracing._union is union
    with pytest.raises(tracing.TraceError):  # the prelude is gone
        stages.trace_intervals([e for e in events
                                if e["name"] != "spin_kernel"])
    assert tracing._union is union


def test_recording_reads_the_trace_through_the_real_summary():
    events = synthetic()
    real = tracing.summary
    got: dict = {}
    with stages.recording(got):
        assert tracing.summary is not real
        assert tracing.summary(events) == real(events)
    assert tracing.summary is real
    assert got["trace"]["busy"] == stages.trace_intervals(events)["busy"]
