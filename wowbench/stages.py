"""Where a cell's time goes, by the program's own stages.

    python -m wowbench.stages --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell as ``python -m wowbench`` does (the same ``harness.run``,
the same result line), with the program's spans
(``repro_torch.monitoring``) recording from the window's first submit to
its close, and then prints one more JSON line, ``{"stages": ...}``:

* ``spans``: each span name's count and wall seconds in the window (a
  span's seconds hold its children's);
* ``counters``: the change of each ``monitoring.counters()`` entry over
  the window, where it changed;
* with ``--trace 1``, ``slice_s``, ``idle_s`` and ``idle_by_span``: the
  seconds of the traced slice in which the device ran nothing, by the
  innermost program range open on the host at the time (``outside``
  where none was), which sum to ``idle_s`` (``idle_stacks``), and
  ``idle_by_path``, the same by the whole stack of open ranges, and
  ``longest_gaps``, the longest stretches with no device work by the
  stages they span; a chunk's ``chunk.hops`` range carries its mode,
  ``[replay]``, ``[eager_seed]`` and so on;
* ``metrics``: ``engine.queue_wait_p95_ms``, ``engine.idle_share``,
  ``search.eager_chunk_share``, ``ingest.apply_idle_share``,
  ``ingest.apply_ms`` and ``ingest.refresh_ms`` (``quantities``), each
  None where the run holds nothing for it.

The benchmark's command records no span, so its readers cannot read
these; the run's result line here is the command's, measured with the
spans recording (their cost on the host is in it).
"""
from __future__ import annotations

import contextlib
import json
import sys
import types

import numpy as np

from . import harness, loadgen, tracing

PREFIX = "repro_torch."
OUTSIDE = "outside"
TOP_PATHS = 40  # entries of ``idle_by_path``


def trace_intervals(events: list, summarize=None) -> dict:
    """What the stage reader needs of a traced slice, read once.

    * ``summary``: ``summarize(events)``, by default ``tracing.summary``
      (``recording`` passes the function it replaced);
    * ``t0``, ``t1``: the slice's ends (us);
    * ``busy``: the merged device intervals inside the slice that the
      summary builds for its ``busy_s``, caught from its ``_union`` as it
      runs, so the idle pieces sum to its ``window_s - busy_s``;
    * ``ranges``: the ``repro_torch.*`` host ranges ``(start, end,
      name)``, a parent before its child.

    E10 (ROADMAP) moves this into ``tracing.summary``, which then hands
    its own intervals to ``idle_stacks``."""
    caught = []
    union = tracing._union

    def catch(spans):
        caught.append(union(spans))
        return caught[-1]

    tracing._union = catch
    try:
        summary = (summarize or tracing.summary)(events)
    finally:
        tracing._union = union
    sl = next(e for e in events if e.get("ph") == "X"
              and e.get("name") == tracing.SLICE
              and e.get("cat") == "user_annotation")
    t0 = float(sl["ts"])
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e["name"].startswith(PREFIX)),
                    key=lambda r: (r[0], -r[1]))
    return {"summary": summary, "t0": t0, "t1": t0 + float(sl["dur"]),
            "busy": [tuple(ab) for ab in caught[0]], "ranges": ranges}


def _idle_pieces(trace: dict, spans: list | None):
    """The stretches of the slice with no device work, split at every end
    of a program range: ``(start_us, end_us, stack)`` in time order,
    ``stack`` the names of the ranges open, outermost first."""
    t0, t1, ranges = trace["t0"], trace["t1"], trace["ranges"]
    names = _labels([name for *_, name in ranges], spans or [])
    # a sweep over every end: (time, order, ...); at one time a range
    # closes (0) and the device stops (1) before a range opens (2) and the
    # device starts (3)
    marks = []
    for i, (a, b, _) in enumerate(ranges):
        marks += [(a, 2, i), (b, 0, i)]
    for a, b in trace["busy"]:
        marks += [(a, 3, -1), (b, 1, -1)]
    marks.sort()
    open_: set = set()
    running = False
    prev = t0
    for t, kind, i in marks + [(t1, 4, -1)]:
        t = min(max(t, t0), t1)
        if t > prev and not running:
            yield prev, t, tuple(names[j] for j in sorted(
                open_, key=lambda j: (ranges[j][0], -ranges[j][1])))
        prev = max(prev, t)
        if kind == 0:
            open_.discard(i)
        elif kind == 2:
            open_.add(i)
        elif kind in (1, 3):
            running = kind == 3


def idle_stacks(trace: dict, spans: list | None = None) -> dict:
    """The traced slice's device-idle seconds by the program ranges open
    on the host at the time: ``{(outermost, ..., innermost): seconds}``,
    ``()`` where no ``repro_torch.*`` range was open.  ``trace`` is
    ``trace_intervals``'s (the slice, the summary's busy intervals, the
    ranges), so the values sum to the summary's ``window_s - busy_s``;
    each idle stretch is split exactly at the ranges' ends.  With the
    window's span records (``spans``), a range is labelled with its
    span's ``mode`` too (``_labels``)."""
    out: dict = {}
    for a, b, key in _idle_pieces(trace, spans):
        out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return out


def longest_gaps(trace: dict, spans: list | None = None,
                 top: int = tracing.TOP) -> list:
    """The ``top`` longest stretches of the slice with no device work,
    longest first: ``[seconds, {innermost range: seconds}]``."""
    gaps: list = []
    for a, b, key in _idle_pieces(trace, spans):
        if not gaps or gaps[-1][1] != a:
            gaps.append([a, b, {}])
        gap = gaps[-1]
        gap[1] = b
        name = key[-1] if key else OUTSIDE
        gap[2][name] = gap[2].get(name, 0.0) + (b - a) / 1e6
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[(b - a) / 1e6, parts] for a, b, parts in gaps[:top]]


def _labels(names: list, spans: list) -> list:
    """The trace's program ranges (``names``, in opening order) are the
    last spans the window recorded, where the profiler ran between engine
    calls and kept every range: then each takes its span's ``mode`` as
    ``name[mode]``.  Where the names do not match the records' tail, the
    names stay bare."""
    tail = spans[len(spans) - len(names):] if len(names) <= len(spans) \
        else []
    if [r["name"] for r in tail] != names:
        return names
    return [r["name"] + (f"[{r['attrs']['mode']}]" if "mode" in r["attrs"]
                         else "") for r in tail]


def idle_by_span(stacks: dict) -> dict:
    """``idle_stacks`` by the innermost range (``outside`` for none)."""
    out: dict = {}
    for key, s in stacks.items():
        name = key[-1] if key else OUTSIDE
        out[name] = out.get(name, 0.0) + s
    return out


def idle_under(stacks: dict, names) -> float:
    """Idle seconds with a range open whose name starts with one of
    ``names``, at any depth."""
    return sum(s for key, s in stacks.items()
               if any(n.startswith(tuple(names)) for n in key))


def quantities(spans: list, counters: dict, chunks: int,
               stacks: dict | None, slice_s: float) -> dict:
    """The six stage quantities of a window (see the module docstring):
    ``spans`` its records, ``counters`` the change of each counter over
    it, ``chunks`` the chunks the engine ran in it, ``stacks`` the traced
    slice's ``idle_stacks`` (None untraced) and ``slice_s`` its length."""
    def wall_ms(stage):
        return [(r["t1"] - r["t0"]) * 1e3 for r in spans
                if r["name"] == PREFIX + stage and r["t1"] is not None]

    def median(xs):
        return float(np.median(xs)) if xs else None

    waits = [w for r in spans if r["name"] == PREFIX + "engine.assemble"
             for w in r["attrs"].get("waits_s", ())]
    eager = sum(v for k, v in counters.items()
                if k.startswith("device_search.EAGER_CHUNKS."))
    out = {
        "engine.queue_wait_p95_ms": (float(np.percentile(waits, 95)) * 1e3
                                     if waits else None),
        "search.eager_chunk_share": 100.0 * eager / chunks if chunks else None,
        "ingest.apply_ms": median(wall_ms("engine.ingest_apply")),
        "ingest.refresh_ms": median(wall_ms("engine.refresh")),
        "engine.idle_share": None,
        "ingest.apply_idle_share": None,
    }
    if stacks is not None and slice_s > 0:
        out["engine.idle_share"] = 100.0 * idle_under(
            stacks, (PREFIX + "engine.", PREFIX + "chunk.")) / slice_s
        if any(r["name"] == PREFIX + "engine.ingest_apply" for r in spans):
            out["ingest.apply_idle_share"] = 100.0 * idle_under(
                stacks, (PREFIX + "engine.ingest_apply",
                         PREFIX + "engine.refresh")) / slice_s
    return out


def _span_totals(spans: list) -> dict:
    """Count and wall seconds by name, and by ``name[mode]`` too."""
    out: dict = {}
    for r in spans:
        if r["t1"] is None:
            continue
        keys = [r["name"]]
        if "mode" in r["attrs"]:
            keys.append(f"{r['name']}[{r['attrs']['mode']}]")
        for k in keys:
            n, s = out.get(k, (0, 0.0))
            out[k] = (n + 1, s + r["t1"] - r["t0"])
    return {k: [n, s] for k, (n, s) in sorted(out.items())}


@contextlib.contextmanager
def recording(got: dict):
    """Inside the block, a ``harness.run`` records the program's spans
    from its window's first submit to its close, and leaves in ``got``
    the counters at those two ends (``c0``, ``c1``), the window's
    ``spans``, a traced run's ``trace_intervals`` (``trace``) and its
    result (``out``).  It stands in for the harness's own recording until
    E10 (ROADMAP), which deletes it and this command."""
    from repro_torch import monitoring  # harness put the program on the path

    real_generator, real_summary, real_run = (
        loadgen.load_generator, tracing.summary, harness.run)

    def load_generator(name):
        gen = real_generator(name)

        class Traffic(gen.Traffic):
            def start(self):
                monitoring.clear()
                got["c0"] = monitoring.counters()
                got["on"] = monitoring.tracing()
                got["on"].__enter__()
                super().start()

            def close(self, t_close, limit_s):
                got["on"].__exit__(None, None, None)
                got["c1"] = monitoring.counters()
                got["spans"] = monitoring.spans()
                return super().close(t_close, limit_s)

        return types.SimpleNamespace(Traffic=Traffic,
                                     check_mix=gen.check_mix)

    def summary(events):
        got["trace"] = trace_intervals(events, real_summary)
        return got["trace"]["summary"]

    def run(*args, **kwargs):
        got["out"] = real_run(*args, **kwargs)
        return got["out"]

    loadgen.load_generator, tracing.summary, harness.run = (
        load_generator, summary, run)
    try:
        yield got
    finally:
        loadgen.load_generator, tracing.summary, harness.run = (
            real_generator, real_summary, real_run)


def report(got: dict) -> dict:
    """The ``stages`` object of a run ``recording`` saw."""
    out, spans = got["out"], got["spans"]
    counters = {k: v - got["c0"].get(k, 0) for k, v in got["c1"].items()
                if v != got["c0"].get(k, 0)}
    stacks = idle_stacks(got["trace"], spans) if "trace" in got else None
    slice_s = out["device"].get("window_s", 0.0)
    stages = {"spans": _span_totals(spans), "counters": counters,
              "metrics": quantities(spans, counters,
                                    out["info"]["engine"]["chunks"], stacks,
                                    slice_s)}
    if stacks is not None:
        paths = sorted(stacks.items(), key=lambda kv: -kv[1])
        stages.update(slice_s=slice_s,
                      idle_s=slice_s - out["device"]["busy_s"],
                      idle_by_span=idle_by_span(stacks),
                      idle_by_path=[[" > ".join(k), v]
                                    for k, v in paths[:TOP_PATHS]],
                      longest_gaps=longest_gaps(got["trace"], spans))
    return stages


def main(argv=None) -> int:
    from . import __main__ as command

    got: dict = {}
    with recording(got):
        rc = command.main(argv)
    if rc == 0:
        print(json.dumps({"stages": report(got)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
