"""Injectable filesystem shim and fault injection for the durable index
lifecycle (the port of ``repro.persist.faultfs``; numpy and ``os`` only).

Every byte the persistence subsystem writes (WAL appends, checkpoint
sections, atomic renames, directory fsyncs) goes through an ``OsIO``
instance, so a test can swap in a ``FaultIO`` and kill the writer at any
byte offset, drop fsyncs, or crash at an arbitrary operation, then assert
that recovery reaches a bitwise-identical prefix state.  Reads go through
the io too where recovery mutates state (torn-tail truncation).

Crash models
------------

A real crash leaves the filesystem somewhere between two extremes, both of
which ``FaultIO`` can materialize:

* ``model="flushed"`` (default): every byte written before the crash
  reached disk, including a torn suffix of the final partial write (the
  adversarial model for *torn records*: recovery must find the torn tail
  through the checksums).
* ``model="lost"``: nothing past the last ``fsync`` survives: files roll
  back to their last-synced length, un-fsynced creations disappear, and
  renames whose parent directory was never fsynced are undone (the model
  for *dropped fsyncs*; ``drop_fsync=True`` makes every fsync a silent
  no-op, so a later crash loses everything since the last durable point).

Any state a real crash can produce lies between these two; recovery is
held against both, plus explicit bit flips (``flip_bit``) and truncations
(``truncate_at``).

``EngineFaultPlan`` is the scheduler-level complement: it hooks every hop
chunk and ingest apply of ``repro_torch.serve.lifecycle.ServeEngine``.
"""
from __future__ import annotations

import os
import shutil
import time


class CrashError(Exception):
    """Raised at an injected crash point (``FaultIO`` or ``EngineFaultPlan``)."""


class OsIO:
    """Thin passthrough to the real filesystem.

    Handles returned by ``create``/``open_append`` are plain binary file
    objects; all mutating operations are methods so a fault-injection
    subclass can interpose on every one of them.
    """

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def create(self, path: str):
        return open(path, "wb")

    def open_append(self, path: str):
        return open(path, "ab")

    def write(self, f, data: bytes) -> None:
        f.write(data)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())

    def close(self, f) -> None:
        f.close()

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def fsync_dir(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def remove(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def truncate(self, path: str, length: int) -> None:
        with open(path, "r+b") as f:
            f.truncate(length)


class FaultIO(OsIO):
    """``OsIO`` with an injected crash point and fsync semantics.

    Parameters
    ----------
    crash_after_bytes:
        Raise ``CrashError`` once this many payload bytes have been
        written across all files; the final write is applied *partially*
        up to the crash byte (the kill-at-any-byte-offset capability).
    crash_after_ops:
        Raise after this many mutating operations (writes, fsyncs,
        renames, removals, creates) — for sweeping crash points through a
        checkpoint save, whose structure is op- rather than byte-shaped.
    drop_fsync:
        Make every file fsync a silent no-op (the written bytes stay in
        the "page cache" and are lost at a later ``model="lost"`` crash).
    model:
        What survives the crash — see the module docstring.

    ``ops`` counts mutating operations so a sweep can run once with no
    crash point to learn the op count, then re-run with
    ``crash_after_ops=k`` for every ``k``.
    """

    def __init__(
        self,
        crash_after_bytes: int | None = None,
        crash_after_ops: int | None = None,
        drop_fsync: bool = False,
        model: str = "flushed",
    ):
        if model not in ("flushed", "lost"):
            raise ValueError(f"unknown crash model {model!r}")
        self.crash_after_bytes = crash_after_bytes
        self.crash_after_ops = crash_after_ops
        self.drop_fsync = drop_fsync
        self.model = model
        self.bytes_written = 0
        self.ops = 0
        # durability tracking for the "lost" model
        self._synced_len: dict[str, int] = {}  # path -> length at last fsync
        self._pending_create: set[str] = set()  # created, parent not fsynced
        self._pending_replace: list[tuple[str, str]] = []  # (src, dst)
        self._lens: dict[str, int] = {}  # current (written) length per path

    # ------------------------------------------------------------- crash core
    def _tick(self) -> None:
        self.ops += 1
        if self.crash_after_ops is not None and self.ops > self.crash_after_ops:
            self._crash()

    def _crash(self) -> None:
        if self.model == "lost":
            self._rollback_to_durable()
        raise CrashError(
            f"injected crash (ops={self.ops}, bytes={self.bytes_written}, "
            f"model={self.model})"
        )

    def _rollback_to_durable(self) -> None:
        """Materialize the conservative post-crash state: un-synced bytes,
        creations and renames vanish."""
        for src, dst in reversed(self._pending_replace):
            if os.path.exists(dst):
                os.replace(dst, src)
        self._pending_replace.clear()
        for path in list(self._pending_create):
            if os.path.exists(path):
                OsIO.remove(self, path)
        self._pending_create.clear()
        for path, length in self._synced_len.items():
            if os.path.exists(path) and os.path.getsize(path) > length:
                with open(path, "r+b") as f:
                    f.truncate(length)

    # --------------------------------------------------------------- mutators
    def mkdir(self, path: str) -> None:
        self._tick()
        existed = os.path.isdir(path)
        super().mkdir(path)
        if not existed:
            self._pending_create.add(path)

    def create(self, path: str):
        self._tick()
        f = super().create(path)
        self._pending_create.add(path)
        self._synced_len[path] = 0
        self._lens[path] = 0
        return f

    def open_append(self, path: str):
        self._tick()
        f = super().open_append(path)
        size = os.path.getsize(path)
        self._synced_len.setdefault(path, size)
        self._lens[path] = size
        return f

    def write(self, f, data: bytes) -> None:
        self._tick()
        path = f.name
        if self.crash_after_bytes is not None:
            room = self.crash_after_bytes - self.bytes_written
            if room < len(data):
                # apply the surviving prefix of the torn write, then die
                if room > 0:
                    f.write(data[:room])
                    f.flush()
                    self.bytes_written += room
                    self._lens[path] = self._lens.get(path, 0) + room
                self._crash()
        f.write(data)
        self.bytes_written += len(data)
        self._lens[path] = self._lens.get(path, 0) + len(data)

    def fsync(self, f) -> None:
        self._tick()
        if self.drop_fsync:
            f.flush()  # reaches the "page cache" only
            return
        super().fsync(f)
        self._synced_len[f.name] = self._lens.get(f.name, 0)

    def replace(self, src: str, dst: str) -> None:
        self._tick()
        super().replace(src, dst)
        self._pending_replace.append((src, dst))
        if src in self._pending_create:
            self._pending_create.discard(src)
            self._pending_create.add(dst)

    def fsync_dir(self, path: str) -> None:
        self._tick()
        if self.drop_fsync:
            return
        super().fsync_dir(path)
        norm = os.path.abspath(path)
        # everything directly under (or renamed into) this directory is now
        # durable
        self._pending_replace = [
            (s, d)
            for s, d in self._pending_replace
            if os.path.abspath(os.path.dirname(d)) != norm
        ]
        for p in list(self._pending_create):
            if os.path.abspath(os.path.dirname(p)) == norm:
                self._pending_create.discard(p)

    def remove(self, path: str) -> None:
        self._tick()
        super().remove(path)
        self._pending_create.discard(path)
        self._synced_len.pop(path, None)
        self._lens.pop(path, None)

    def truncate(self, path: str, length: int) -> None:
        self._tick()
        super().truncate(path, length)
        self._lens[path] = length
        if self._synced_len.get(path, 0) > length:
            self._synced_len[path] = length


class EngineFaultPlan:
    """Fault plan for ``ServeEngine(fault_plan=...)``.

    The engine calls ``on_chunk`` before every executed hop chunk and
    ``on_ingest_apply`` before every ingest micro-batch apply: it delays
    (slow waves) or raises ``CrashError`` at a configured point, such as
    between the write-ahead log's ack and the apply, the window the
    logged ingest queue must survive.  Byte-level faults compose by also
    handing the engine's index a ``FaultIO``; SIGKILL-grade crashes are
    left to subprocess tests.

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
        applied: earlier batches are applied, later ones logged and acked
        but still queued.
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


# --------------------------------------------------------------- test helpers
def flip_bit(path: str, byte_index: int, bit: int = 0) -> None:
    """Flip one bit of a file in place (corruption injection)."""
    with open(path, "r+b") as f:
        f.seek(byte_index)
        b = f.read(1)
        f.seek(byte_index)
        f.write(bytes([b[0] ^ (1 << bit)]))


def truncate_at(path: str, length: int) -> None:
    """Truncate a file to ``length`` bytes (torn-write injection)."""
    with open(path, "r+b") as f:
        f.truncate(length)
