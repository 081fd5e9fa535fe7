"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result.

Set-up (``setup_s``, from process start to the window's first submit)
makes the configuration's base rows (``data.make_base``), loads its base
index (``index_cache``: built with ``insert_batch(backend="device")`` by
the checkout's first run, loaded by the program's checkpoint cold start),
starts a ``ServeEngine`` with the configuration's and the mix's settings,
lets the mix's generator make the run's inputs from the seed and warm up
(``Traffic.warm``), and calls ``warmup()``, which runs and captures every
chunk shape the scheduler can assemble.

The window runs the mix for ``seconds``.  When it closes the generator
sends nothing more and finishes what the engine holds (``Traffic.close``).
Then the device's peak memory is read, the program's state is freed, the
base rows are made again, and ``reference.judge`` holds every reply the
generator names against the exact answers.

With ``trace`` a profiler session covers the window's last
``trace_seconds`` (``tracing.Session``), and is closed and read once the
window has closed, so that writing and reading the trace falls outside
it; the slice's two ends on the benchmark's clock go with its summary, so
that the readers can take the requests sent inside it.
"""
from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from . import data, index_cache, loadgen, reference, spec

sys.path.insert(0, str(spec.ROOT / "src"))  # the program under test


@dataclass
class Readings:
    """What the metric readers read (``spec.load_reader``)."""

    cfg: dict  # the configuration file
    setup_s: float
    window_s: float
    requests: dict  # loadgen.Log.arrays() of the window's requests
    t_close: float  # the clock at the window's close
    recall: float  # the window's replies, or an ingest mix's probe
    engine: dict  # ServeEngine.engine_stats() over the window (deltas)
    captures: int  # capture events in the window
    ingest: dict | None = None  # rows, searches, lag_s of the window
    trace: dict | None = None  # tracing.summary() + the slice's t0, t1


def _stats(eng) -> dict:
    s = eng.engine_stats()
    return {k: s[k] for k in ("served", "waves", "chunks", "degraded",
                              "expired", "rejected")}


def run(cell: dict, cfg: dict, mix: dict, bench: dict, seed: int,
        seconds: float, trace: bool, t_process: float, device="cuda",
        drain_s: float = 60.0, cache_dir=None) -> dict:
    """One run -> the result's fields (see ``__main__``)."""
    import torch

    from repro_torch import monitoring
    from repro_torch.serve.lifecycle import EngineConfig, ServeEngine

    clock = time.perf_counter
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    events: list = []
    monitoring.register_listener(lambda kind, name, s: events.append(kind))
    phases = {}

    def phase(name, t):
        sync()
        phases[name] = clock() - t
        return clock()

    t = clock()
    base = data.make_base(cfg["n"], cfg["d"], cfg["data_seed"], device)
    t = phase("data_s", t)
    idx, phases["built_s"] = index_cache.load(cfg, device, cache_dir)
    t = phase("index_s", t)
    se, ix = cfg["search"], cfg["index"]
    eng = ServeEngine(index=idx, config=EngineConfig(
        k=se["k"], width=se["width"], vec_dtype=ix["vec_dtype"],
        visited=se["visited"], adaptive=False, chunk=tuple(se["chunk"]),
        build_backend="device", **mix["engine"]), device=device)
    sess = None
    if trace:
        from . import tracing

        tracing.warm_up()  # the profiler's first start is slow
        sess = tracing.Session()
    tracing_on = [False]

    def span(name):
        return sess.span(name) if tracing_on[0] else contextlib.nullcontext()

    gen = loadgen.load_generator(mix["generator"])
    traffic = gen.Traffic(eng, idx, cfg, mix, base, seed, seconds,
                          clock=clock, span=span, device=device)
    del base  # made again for the reference, after the program is freed
    traffic.warm()
    eng.warmup()
    t = phase("warm_s", t)
    n_events = len(events)
    stats0 = _stats(eng)
    host = {"threads": torch.get_num_threads(),
            "cpus": len(os.sched_getaffinity(0))}

    # ------------------------------------------------------------ window
    t0 = clock()
    setup_s = t0 - t_process
    end = t0 + seconds
    tr_start = end - mix["trace_seconds"]
    summary = None
    traffic.start()
    while clock() < end:
        traffic.tick()
        if sess is not None and not tracing_on[0] and clock() >= tr_start:
            sess.start()
            tracing_on[0] = True
            tr_a = clock()
    t_close = clock()
    stats1 = _stats(eng)
    captures = sum(1 for k in events[n_events:] if k == "capture")
    if tracing_on[0]:
        summary = sess.stop()
        tracing_on[0] = False
        summary["t0"], summary["t1"] = tr_a, t_close

    # ------------------------------------------------------- after close
    traffic.close(t_close, drain_s)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del eng, idx
    traffic.eng = traffic.index = traffic.reads.eng = None
    if traffic.probe is not None:
        traffic.probe.eng = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    phases["after_close_s"] = clock() - t_close

    # -------------------------------------------------------- reference
    t_ref = clock()
    base = data.make_base(cfg["n"], cfg["d"], cfg["data_seed"], device)
    vecs, attrs = base.vectors, base.attrs.cpu().numpy()
    extra = traffic.extra_rows()
    if extra is not None:
        vecs = torch.cat([vecs, torch.as_tensor(extra[0], device=vecs.device)])
        attrs = np.concatenate([attrs, extra[1]])
    k = cfg["search"]["k"]
    checks, correct, recall = {}, True, None
    for rs in traffic.replies():
        lg = rs["log"]
        rows, ids, dists = lg.answers(k)
        qidx = np.asarray(lg.qidx, np.int64)[rows]
        v = reference.judge(
            vecs, attrs, rs["queries"], rs["ranges"], qidx, ids, dists, k=k,
            limits=cfg["checks"], device=device,
            unanswered=len(lg.qidx) - len(rows) - lg.rejected,
            recall_mask=rs["recall"][qidx])
        checks.update({rs["prefix"] + n: c for n, c in v["checks"].items()})
        correct = correct and v["correct"]
        recall = v["recall"]  # the last set's: the probe where there is one
    for n, c in traffic.checks().items():
        checks[n] = c
        correct = correct and c[0] <= c[1]
    phases["reference_s"] = clock() - t_ref

    rd = traffic.readings()
    r = Readings(
        cfg=cfg, setup_s=setup_s, window_s=t_close - t0,
        requests=rd["requests"], t_close=t_close, recall=recall,
        engine={k_: stats1[k_] - stats0[k_] for k_ in stats0},
        captures=captures, ingest=rd["ingest"], trace=summary)
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], trace):
        v = spec.load_reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    reqs = rd["requests"]
    fail = (~np.isfinite(reqs["t_reply"])) | reqs["degraded"]
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(len(fail)),
           "failed": int(fail.sum()), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    # not a metric: where set-up went, what the engine did in the window
    # and the host threads, for whoever reads a run's output
    out["info"] = {"phases": phases, "engine": r.engine,
                   "captures": captures, "host": host}
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in checks.items()}
    return out
