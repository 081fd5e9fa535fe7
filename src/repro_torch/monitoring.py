"""Capture and build events, spans and counters: the port's instrumentation,
and its counterpart of ``jax.monitoring``.

**Events.**  Where the JAX package pays an XLA compile, the port pays a
CUDA-graph capture (``core.device_search._GraphedChunk``) or a kernel
library built by ``nvcc`` or loaded at first use (``kernels._build``).
Each of those sites reports one event here as it happens, and
``repro_torch.analysis.compile_guard.CaptureCounter`` listens, so a test
can assert that nothing was captured or built after ``warmup()``.
Events are ``(kind, name, secs)``: ``kind`` is ``"capture"``, ``"build"``
or ``"load"``, ``name`` says what (a chunk's shape, a kernel's name) and
``secs`` the wall seconds it took.  Listeners are called on the thread
that reports the event.

**Spans.**  ``span(name, id=None, **attrs)`` marks one stage of the
program, named ``repro_torch.<layer>.<stage>``.  While tracing is off (the
default) it tests one module flag and returns the shared no-op
``NO_SPAN``: no clock is read, nothing is recorded and torch is not
touched.  Inside ``tracing()`` each span appends one record to an
in-memory list, ``{"name", "t0", "t1", "parent", "id", "attrs"}``: its
ends on ``time.perf_counter()`` (the clock the benchmark and the
launcher use), the index of the span that enclosed it on the same thread
(None at the top), the request, wave or ingest batch it serves, and the
small attributes given to ``span()`` or later to its ``set()``.  Where a
profiler session is open it also enters
``torch.profiler.record_function(name)``, so the session shows the stage
on the timeline of the kernels and copies it launched (outside a session
that range would show nowhere and costs ~10 us, more than the record).
A span synchronises nothing with the device: its times are the host's,
and the device work it queued may run after it closes.
``spans()`` returns the records and ``clear()`` drops them; until then
they are kept, so trace a bounded stretch of work.

**Counters.**  ``counters()`` returns every counter the program keeps, as
one flat dict ``{"<source>.<name>": int}``, read where the counters live
through the sources the modules register (``register_counters``) as they
are imported: the hop loop's graph replays, captures, replayed kernel
launches and eager chunks (``device_search``), the kernel wrappers'
launches (``kernels``), the build arenas' uploads and scatters
(``snapshot``) and the engines' snapshot refreshes and serving-set
copy-ins (``lifecycle``).  Counters count whether or not tracing is on.
"""
from __future__ import annotations

import contextlib
import threading
import time

_lock = threading.Lock()
_listeners: list = []


def register_listener(fn) -> None:
    """Call ``fn(kind, name, secs)`` on every later event (permanent)."""
    with _lock:
        _listeners.append(fn)


def record_event(kind: str, name: str, secs: float) -> None:
    """Report one capture, build or load to every listener."""
    with _lock:
        listeners = list(_listeners)
    for fn in listeners:
        fn(kind, name, secs)


# ------------------------------------------------------------------- spans
_on = False  # the one flag every span() tests
_records: list = []
_open = threading.local()  # .stack: indices of the thread's open spans


class _NoSpan:
    """The context ``span()`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, id, attrs: dict):
        self.rec = {"name": name, "t0": None, "t1": None, "parent": None,
                    "id": id, "attrs": attrs}
        self.rf = None

    def __enter__(self):
        import torch

        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = []
        rec = self.rec
        rec["parent"] = stack[-1] if stack else None
        with _lock:
            stack.append(len(_records))
            _records.append(rec)
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(rec["name"])
            self.rf.__enter__()
        rec["t0"] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec["t1"] = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.stack.pop()
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the stage has run."""
        self.rec["attrs"].update(attrs)


def span(name: str, id=None, **attrs):
    """A context that records the stage ``name`` while tracing is on, and
    the shared ``NO_SPAN`` otherwise (see the module docstring)."""
    if not _on:
        return NO_SPAN
    return _Span(name, id, attrs)


def enabled() -> bool:
    """Whether spans record: for a site whose attributes cost work."""
    return _on


@contextlib.contextmanager
def tracing(on: bool = True):
    """Switch span recording on (or off) inside the block; the previous
    setting comes back at its end.  Records stay until ``clear()``."""
    global _on
    prev, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = prev


def spans() -> list:
    """The records so far, oldest first (a span's record is added when it
    opens, so a parent precedes its children; ``t1`` is None while open)."""
    with _lock:
        return list(_records)


def clear() -> None:
    """Drop every record; call it with no span open."""
    with _lock:
        _records.clear()


# ---------------------------------------------------------------- counters
_sources: dict = {}


def register_counters(prefix: str, source) -> None:
    """Report ``source`` under ``prefix`` in ``counters()``: a dict of
    counts, read as it stands at each call, or a function returning one
    (for counts summed over live instances)."""
    with _lock:
        _sources[prefix] = source


def counters() -> dict:
    """Every registered counter, ``{"<prefix>.<name>": count}``."""
    with _lock:
        sources = list(_sources.items())
    out = {}
    for prefix, src in sources:
        for name, v in (src() if callable(src) else src).items():
            out[f"{prefix}.{name}"] = v
    return out
