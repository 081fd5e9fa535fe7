"""The trace reader and the metric readers' arithmetic on a synthetic
trace and synthetic readings (CPU; no profiler runs)."""
import numpy as np
import pytest

from wowbench import peaks, spec, tracing
from wowbench.harness import Readings


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def synthetic():
    """A 1,000 us slice: prelude spins before it, kernels at 100-300 (two
    overlapping), 500-600 (gather_norm_dot) and one past its end, under a
    ``wowbench.step`` range with a host op in the 300-500 gap."""
    return [
        ev("spin_kernel", -500, 400),
        ev(tracing.SLICE, 0, 1000, cat="user_annotation"),
        ev(tracing.SLICE, 0, 1000, cat="gpu_user_annotation"),
        ev("wowbench.step", 50, 800, cat="user_annotation"),
        ev("aten::nonzero", 310, 180, cat="cpu_op"),
        ev("sort_kernel", 100, 150),
        ev("sort_kernel", 200, 100),
        ev("void gather_norm_dot_kernel<float>", 500, 100),
        ev("Memcpy DtoH", 950, 100, cat="gpu_memcpy"),
    ]


def test_summary_union_gaps_and_names():
    s = tracing.summary(synthetic())
    assert s["window_s"] == pytest.approx(1000e-6)
    # union: 100-300, 500-600, 950-1000 (clipped) = 350 us
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["device_s"]["sort_kernel"] == pytest.approx(250e-6)
    assert s["prelude_kept"] == 1
    longest = s["idle_gaps"][0]
    assert longest[1] == pytest.approx(350e-6)  # 600-950
    gap_300 = next(g for g in s["idle_gaps"]
                   if g[1] == pytest.approx(200e-6))
    assert gap_300[0] == "wowbench.step > aten::nonzero"
    assert s["idle_gaps"][-1][1] == pytest.approx(100e-6)  # 0-100
    assert s["device_ops"][0][0] == "sort_kernel"


def test_summary_fails_without_the_prelude():
    events = [e for e in synthetic() if e["name"] != "spin_kernel"]
    with pytest.raises(tracing.TraceError, match="prelude"):
        tracing.summary(events)


def readings(cfg_name="wow-sift128", **trace):
    cfg = spec.load_config(cfg_name)
    req = {"t_submit": np.array([0.0, 0.1, 0.2, 0.3]),
           "t_reply": np.array([0.5, 0.7, 1.5, np.inf]),
           "dc": np.array([200, 300, 250, 0]),
           "hops": np.array([60, 70, 80, 0]),
           "degraded": np.array([False, False, False, True]),
           "qidx": np.arange(4)}
    ingest = {"rows": 1024, "searches": 4096,
              "arrival": np.array([0.0, 0.25, 0.5, 0.75]),
              "lag_s": np.array([0.2, 0.4, 0.3, 1.0])}
    return Readings(cfg=cfg, setup_s=12.5, window_s=1.0,
                    requests=req, t_close=1.0, recall=0.99,
                    engine={"served": 30, "waves": 4}, captures=2,
                    ingest=ingest, trace=dict(trace) if trace else None)


def test_end_to_end_readers():
    r = readings()
    assert spec.load_reader("qps")(r) == 2.0  # two full replies by the close
    assert spec.load_reader("latency_p95_ms")(r) == np.inf
    r.requests["degraded"][3] = False
    r.requests["t_reply"][3] = 1.3
    lat = np.array([0.5, 0.6, 1.3, 1.0])
    assert spec.load_reader("latency_p95_ms")(r) == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    assert spec.load_reader("ingest_rows_per_s")(r) == 1024.0
    assert spec.load_reader("setup_s")(r) == 12.5
    assert spec.load_reader("recall_at_10")(r) == 0.99


def test_layer_readers():
    r = readings()
    assert spec.load_reader("engine.wave_rows")(r) == 7.5
    assert spec.load_reader("engine.captures_after_warmup")(r) == 2
    assert spec.load_reader("search.dc_per_query")(r) == 250.0
    assert spec.load_reader("search.hops_per_query")(r) == 70.0
    assert spec.load_reader("ingest.searches_per_row")(r) == 4.0
    assert spec.load_reader("ingest.lag_p95_ms")(r) == pytest.approx(
        np.percentile([0.2, 0.4, 0.3, 1.0], 95) * 1e3)
    r.ingest["lag_s"][1] = np.inf  # a batch never applied
    assert spec.load_reader("ingest.lag_p95_ms")(r) == np.inf
    r.trace = {"t0": 0.2}  # a traced run: the batches from 0.2 on go
    assert spec.load_reader("ingest.lag_p95_ms")(r) == pytest.approx(200.0)
    r.trace = None
    assert spec.load_reader("device.idle_share")(r) is None
    assert spec.load_reader("kernel.gather_norm_dot.roofline")(r) is None
    # the ingest cells' names of the shared readers
    assert spec.load_reader("engine.captures_after_warmup.ingest")(r) == 2
    assert spec.load_reader("ingest.read_qps")(r) == 2.0
    assert spec.load_reader("ingest.read_p95_ms")(r) == np.inf
    assert spec.load_reader("device.idle_share.ingest")(r) is None
    r.ingest = None  # a read mix
    assert spec.load_reader("ingest_rows_per_s")(r) is None
    assert spec.load_reader("ingest.searches_per_row")(r) is None
    assert spec.load_reader("ingest.lag_p95_ms")(r) is None


@pytest.mark.parametrize("cfg_name", ["wow-sift128", "wow-gist960"])
def test_roofline_and_idle_share(cfg_name):
    d = spec.load_config(cfg_name)["d"]
    r = readings(cfg_name, window_s=0.5, busy_s=0.2, t0=0.05, t1=0.25,
                 device_s={"sort": 0.1})
    # the slice holds the requests sent at 0.1 and 0.2
    dc, hops = 300 + 250, 70 + 80
    nbytes = dc * (4 * d + 8 + 8) + hops * 4 * d
    kernel_s = 2.0 * nbytes / peaks.HBM_BW  # half the rate
    assert spec.load_reader("kernel.gather_norm_dot.roofline")(r) is None
    r.trace["device_s"]["void gather_norm_dot_kernel<float>"] = kernel_s
    assert spec.load_reader("kernel.gather_norm_dot.roofline")(r) == \
        pytest.approx(50.0)
    for name in ("device.idle_share", "device.idle_share.ingest"):
        assert spec.load_reader(name)(r) == pytest.approx(60.0)
    r.trace["t0"] = r.trace["t1"] = 0.26  # a slice no request was sent in
    assert spec.load_reader("kernel.gather_norm_dot.roofline")(r) is None
