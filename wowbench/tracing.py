"""The traced slice of a ``--trace 1`` run: a profiler session over part of
the window, read into device busy time, idle gaps and kernel times.

The trace reader and its prelude are a copy of ``chip_smoke.py::_trace``.
The profiler (kineto) files the first device records of a session as out
of its window and drops them, so each session opens with ``PRELUDE`` spin
kernels, synchronised before the slice starts, which take that loss; every
figure leaves them out, and a session in which the profiler dropped the
whole prelude fails, since it may have dropped records of the slice too.

The slice is the interval of the ``wowbench.slice`` range recorded around
it, in the trace's own time base, and lasts the mix's ``trace_seconds``
from the end of the prelude (the tracer's first start, which can take
seconds, is paid in set-up by ``warm_up``).  Device time is the union of the
kernel, copy and set spans clipped to it; an idle gap is a stretch of the
slice with no device span, labelled by the benchmark's own range
(``wowbench.step``, ``wowbench.submit``, ``wowbench.submit_ingest``)
covering its middle, and the innermost host operation there.
"""
from __future__ import annotations

import json
import os
import tempfile

import torch

PRELUDE = 256  # spin kernels that open each profiler session
PRELUDE_CYCLES = 1_000_000  # ... of about 0.5 ms each
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "wowbench.slice"
TOP = 10  # entries of each breakdown list


class TraceError(RuntimeError):
    pass


def warm_up() -> None:
    """Open and close one profiler session on a few kernels, so that the
    window's session does not pay the tracer's first start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(4):
            torch.cuda._sleep(PRELUDE_CYCLES)
        torch.cuda.synchronize()


class Session:
    """``start()`` opens the profiler and runs the prelude; ``span(name)``
    is a profiler range named ``wowbench.<name>``; ``stop()`` closes the
    session and returns ``summary()`` of its trace."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self._slice = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        for _ in range(PRELUDE):
            torch.cuda._sleep(PRELUDE_CYCLES)
        torch.cuda.synchronize()
        self._slice = torch.profiler.record_function(SLICE)
        self._slice.__enter__()

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(f"wowbench.{name}")

    def stop(self) -> dict:
        torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:  # under TMPDIR
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        return summary(trace.get("traceEvents", []))


def _union(spans):
    """Sorted, merged intervals of ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(t: float, host: list, marks: list) -> str:
    """What the host was doing at ``t``: the benchmark's range around it
    and the innermost host operation there."""
    mark = next((name for a, b, name in reversed(marks) if a <= t <= b),
                "wowbench.harness")
    op = None
    for a, b, name in host:  # sorted by start
        if a > t:
            break
        if b >= t:
            op = name
    return mark if op is None else f"{mark} > {op[:100]}"


def summary(events: list) -> dict:
    """Read a chrome trace's events: the slice's wall seconds, device busy
    seconds (union), device time by operation name, the longest idle gaps
    by label, and the prelude records kept."""
    sl = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise TraceError("the trace holds no slice range")
    t0 = float(sl[0]["ts"])
    t1 = t0 + float(sl[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    spin = [e for e in dev if "spin_kernel" in e["name"]]
    if not spin:
        raise TraceError(f"the profiler dropped all {PRELUDE} prelude "
                         "records, so it may have dropped records of the "
                         "slice")
    by_name: dict = {}
    spans = []
    for e in dev:
        if "spin_kernel" in e["name"]:
            continue
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    merged = _union(spans)
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], t0
    for a, b in merged + [[t1, t1]]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                             "cuda_runtime",
                                                             "cuda_driver"))
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("wowbench.")
                   and e["name"] != SLICE)
    gaps.sort(reverse=True)
    idle = [[_label((a + b) / 2, host, marks), g / 1e6]
            for g, a, b in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "device_s": {k: v / 1e6 for k, v in by_name.items()},
            "device_ops": [[k[:120], v / 1e6] for k, v in top],
            "idle_gaps": idle, "prelude_kept": len(spin)}
