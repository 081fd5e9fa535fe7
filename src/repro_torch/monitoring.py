"""Capture and build events: the port's counterpart of ``jax.monitoring``.

Where the JAX package pays an XLA compile, the port pays a CUDA-graph
capture (``core.device_search._GraphedChunk``) or a kernel library built
by ``nvcc`` or loaded at first use (``kernels._build``).  Each of those
sites reports one event here as it happens, and
``repro_torch.analysis.compile_guard.CaptureCounter`` listens, so a test
can assert that nothing was captured or built after ``warmup()``.

Events are ``(kind, name, secs)``: ``kind`` is ``"capture"``, ``"build"``
or ``"load"``, ``name`` says what (a chunk's shape, a kernel's name) and
``secs`` the wall seconds it took.  Listeners are called on the thread
that reports the event.
"""
from __future__ import annotations

import threading

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
