"""The traffic generator and a whole run of each mix against the program's
``ServeEngine`` on the CPU, at n 512 and d 16 for about a second."""
import copy
import time

import numpy as np
import pytest
import torch

from wowbench import data, harness, index_cache, loadgen, spec

BENCH = spec.load_benchmark()


def tiny(cell: str):
    """``cell``'s entry, configuration and mix cut to a CPU test's size:
    n 512, d 16, a pool of 256 queries, 32 clients in waves of 16, and
    for an ingest mix 64-row micro-batches every half second and a probe
    of 64 queries."""
    w = spec.find_cell(BENCH, cell)
    cfg = copy.deepcopy(spec.load_config(w["config"]))
    mix = copy.deepcopy(loadgen.load_mix(w["traffic"]))
    cfg.update(n=512, d=16)
    cfg["index"]["build_batch"] = 128
    mix.update(pool=256, clients=32)
    eng = {"max_wave": 16, "max_slots": 32, "queue_cap": 256}
    if mix["ingest"]:
        eng.update(ingest_share=mix["engine"]["ingest_share"],
                   ingest_batch=64)
        mix["ingest"].update(batch_rows=64, rows_per_s=128)
        mix["probe"]["queries"] = 64
    mix["engine"] = eng
    return w, cfg, mix


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """One index cache for the module: each tiny configuration is built
    once and loaded by every later test."""
    return tmp_path_factory.mktemp("index")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _traffic(cell, cache, seconds=1.0):
    from repro_torch.serve.lifecycle import EngineConfig, ServeEngine

    w, cfg, mix = tiny(cell)
    base = data.make_base(cfg["n"], cfg["d"], cfg["data_seed"], "cpu")
    idx, _ = index_cache.load(cfg, "cpu", cache)
    se = cfg["search"]
    eng = ServeEngine(index=idx, config=EngineConfig(
        k=se["k"], width=se["width"], visited=se["visited"], adaptive=False,
        chunk=tuple(se["chunk"]), build_backend="device", **mix["engine"]),
        device="cpu")
    gen = loadgen.load_generator(mix["generator"])
    traffic = gen.Traffic(eng, idx, cfg, mix, base, 11, seconds)
    traffic.warm()
    eng.warmup()
    return idx, eng, mix, traffic


def test_closed_read_loop_keeps_every_client_waiting(cache):
    _, eng, mix, traffic = _traffic("sift128-read", cache)
    traffic.start()
    assert traffic.reads.outstanding == mix["clients"] == eng.queue_len
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        traffic.tick()
        assert traffic.reads.outstanding == mix["clients"]
    traffic.close(time.perf_counter(), 30)
    a = traffic.readings()["requests"]
    assert traffic.reads.outstanding == 0 and np.isfinite(a["t_reply"]).all()
    assert (a["t_reply"] >= a["t_submit"]).all()
    assert len(a["qidx"]) > mix["clients"]  # clients sent again
    # the pool's queries in turn
    np.testing.assert_array_equal(a["qidx"],
                                  np.arange(len(a["qidx"])) % mix["pool"])
    assert (a["dc"] > 0).all() and not a["degraded"].any()


def test_closed_ingest_loop_keeps_batches_pending(cache):
    """The ingest stream sends its micro-batches on their schedule,
    whatever the engine is doing, and each is in the index once the
    engine no longer holds it."""
    idx, eng, mix, traffic = _traffic("sift128-ingest", cache, 2.0)
    ing = mix["ingest"]
    n0 = len(idx)
    assert n0 == 512 + ing["warm_batches"] * ing["batch_rows"]
    traffic.start()
    t0 = traffic.t0
    period = ing["batch_rows"] / ing["rows_per_s"]
    while time.perf_counter() < t0 + 2.0:
        traffic.tick()
        due = int((time.perf_counter() - t0) / period) + 1
        assert len(traffic.batches) <= due
        applied = len(traffic.batches) - eng.pending_ingest
        assert len(idx) == n0 + applied * ing["batch_rows"]
    assert len(traffic.batches) >= 3
    arrivals = [b[0] for b in traffic.batches]
    np.testing.assert_allclose(np.diff(arrivals), period)
    traffic.close(time.perf_counter(), 60)
    assert eng.pending_ingest == 0 and traffic.reads.outstanding == 0
    assert len(idx) == n0 + len(traffic.batches) * ing["batch_rows"]
    lag = traffic.readings()["ingest"]["lag_s"]
    assert len(lag) == len(traffic.batches) and (lag > 0).all()
    assert np.isfinite(lag).all() and traffic.checks() == {
        "rows_missing": [0, 0]}
    # a quarter of the reads range over the ingested rows' attributes
    fresh = traffic.ranges[traffic.fresh]
    assert traffic.fresh.mean() == pytest.approx(1 / ing["fresh_every"],
                                                 abs=0.01)
    assert (fresh[:, 0] >= 512).all()
    assert (traffic.ranges[~traffic.fresh][:, 1] < 512).all()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_whole_run_on_the_cpu(cell, cache):
    w, cfg, mix = tiny(cell)
    out = harness.run(w, cfg, mix, BENCH, 2**31 + 5, 1.0, False,
                      time.perf_counter(), device="cpu", drain_s=30,
                      cache_dir=cache)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in spec.metrics_for(BENCH, cell, trace=False)}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())
