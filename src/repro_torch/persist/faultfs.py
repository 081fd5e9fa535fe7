"""Fault injection for the serve engine's request lifecycle: the port of
the engine-level half of ``repro.persist.faultfs``.

``EngineFaultPlan`` hooks every executed hop chunk and every ingest apply
of ``repro_torch.serve.lifecycle.ServeEngine``: it delays (slow waves,
through an injectable ``sleep`` that a deterministic test points at its
virtual clock) or raises ``CrashError`` at an exact scheduler point.  The
byte-level shims of the durable lifecycle (``OsIO``, ``FaultIO``, crash
models, bit flips) come with the write-ahead log (ROADMAP A6).
"""
from __future__ import annotations

import time


class CrashError(Exception):
    """Raised at an injected crash point."""


class EngineFaultPlan:
    """Fault plan for ``ServeEngine(fault_plan=...)``.

    The engine calls ``on_chunk`` before every executed hop chunk and
    ``on_ingest_apply`` before every ingest micro-batch apply.

    Parameters
    ----------
    slow_chunk_every:
        Delay every Nth executed chunk (0 = never) by ``slow_chunk_s``.
    slow_chunk_s:
        The injected delay in seconds, applied through ``sleep``.
    crash_after_chunks:
        Raise ``CrashError`` once this many chunks have executed.
    crash_after_ingest_applies:
        Raise ``CrashError`` once this many ingest micro-batches have been
        applied: earlier batches are applied, later ones still queued.
    sleep:
        Delay implementation (default ``time.sleep``); tests pass a
        virtual clock's ``advance`` for deterministic deadline storms.
    """

    def __init__(
        self,
        slow_chunk_every: int = 0,
        slow_chunk_s: float = 0.0,
        crash_after_chunks: int | None = None,
        crash_after_ingest_applies: int | None = None,
        sleep=None,
    ):
        self.slow_chunk_every = int(slow_chunk_every)
        self.slow_chunk_s = float(slow_chunk_s)
        self.crash_after_chunks = crash_after_chunks
        self.crash_after_ingest_applies = crash_after_ingest_applies
        self.sleep = sleep if sleep is not None else time.sleep
        self.chunks = 0
        self.ingest_applies = 0

    def on_chunk(self) -> None:
        self.chunks += 1
        if (
            self.crash_after_chunks is not None
            and self.chunks > self.crash_after_chunks
        ):
            raise CrashError(f"injected engine crash (chunk {self.chunks})")
        if self.slow_chunk_every and self.chunks % self.slow_chunk_every == 0:
            self.sleep(self.slow_chunk_s)

    def on_ingest_apply(self) -> None:
        self.ingest_applies += 1
        if (
            self.crash_after_ingest_applies is not None
            and self.ingest_applies > self.crash_after_ingest_applies
        ):
            raise CrashError(
                f"injected engine crash (ingest apply {self.ingest_applies})"
            )
