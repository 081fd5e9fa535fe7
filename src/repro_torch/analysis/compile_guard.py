"""Runtime capture guard: the port of ``repro.analysis.compile_guard``.

The port's counterpart of an XLA compile is a CUDA-graph capture or a
kernel library built or loaded at first use.  ``CaptureCounter`` counts
them by the events their sites report (``repro_torch.monitoring``: one
at ``core.device_search._GraphedChunk``'s capture, one at each ``nvcc``
build and each uncached load in ``kernels._build``), so tests can assert
shape stability directly:

    with CaptureCounter() as warm:
        eng.warmup()
    with CaptureCounter() as serving:
        ... serve traffic, grow the index, serve again ...
    assert serving.count == 0   # nothing captured or built after warmup

The event bus has no per-listener unregister, so one permanent
module-level listener is installed lazily and dispatches to whichever
counters are currently active — entering/exiting the context manager
only mutates the active set, under a lock (events may come from any
thread).
"""
from __future__ import annotations

import sys
import threading
import time

_lock = threading.Lock()
_active: list["CaptureCounter"] = []
_installed = False


def _dispatch(kind: str, name: str, secs: float) -> None:
    with _lock:
        counters = list(_active)
    for c in counters:
        c._record(kind, name, secs)


def _ensure_listener() -> None:
    global _installed
    with _lock:
        if _installed:
            return
        from ..monitoring import register_listener

        register_listener(_dispatch)
        _installed = True


class CaptureCounter:
    """Context manager counting CUDA-graph captures and kernel-library
    builds and loads while active.  ``count`` is their total,
    ``by_kind`` splits it (``capture``/``build``/``load``) and ``events``
    lists ``(kind, name, secs)`` in order."""

    def __init__(self, label: str = "", verbose: bool = False):
        self.label = label
        self.verbose = verbose
        self.count = 0
        self.total_secs = 0.0
        self.by_kind: dict[str, int] = {}
        self.events: list[tuple[str, str, float]] = []
        self._mu = threading.Lock()

    def _record(self, kind: str, name: str, secs: float) -> None:
        with self._mu:
            self.count += 1
            n = self.count
            self.total_secs += secs
            self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
            self.events.append((kind, name, secs))
        if self.verbose:
            tag = f" [{self.label}]" if self.label else ""
            print(f"[wowlint]{tag} {kind} #{n}: {name} (+{secs:.3f}s)",
                  file=sys.stderr, flush=True)

    def __enter__(self) -> "CaptureCounter":
        _ensure_listener()
        with _lock:
            _active.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            if self in _active:
                _active.remove(self)
        self.wall_secs = time.perf_counter() - self._t0


def trace_compiles(label: str = "serve") -> CaptureCounter:
    """Verbose counter for launcher-level tracing (``--trace-compiles``):
    every capture, build and load prints to stderr as it happens, so a
    warm-up gap shows up as a timestamped line instead of a silent p99
    spike."""
    return CaptureCounter(label=label, verbose=True)
