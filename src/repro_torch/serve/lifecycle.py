"""The serve engine: a request lifecycle over the WoW index, on a torch
device.  The port of ``repro.serve.lifecycle``; the stages and names are
the reference's:

**Admission** — ``submit`` places a request in a bounded queue with an
absolute deadline (``timeout_s`` from the injected clock).  At
``queue_cap`` it is rejected with a ``retry_after`` hint from the live
service rate; the queue riding above ``high_water`` across consecutive
submissions flips the engine into load-shedding mode.

**Scheduling** — waves are assembled from the queue head into power-of-two
buckets and kept as slot-based in-flight state.  The hop loop runs as
resumable chunks over an explicit ``HopState`` (``device_search.
_run_chunk``); at every chunk boundary finished requests are replied at
once, survivors are compacted into smaller buckets, and new waves
interleave round-robin with the stragglers.  Ingest shares the scheduler
through a deficit counter (``ingest_share``).

**Execution** — the fused hop pipeline; with ``adaptive`` the hashed
visited filter (``visited_filter_bits_from_hist``) and the chunk schedule
(``chunk_schedule_from_hist``) follow the live hop histogram, both
pow2-quantised.  Trajectories are row-independent and iteration-indexed,
so for equal knobs the engine's replies are those of a one-shot
``search_batch``: bit for bit where the distances do not depend on the
batch size (the CUDA kernel; the plain versions on the CPU).

**Graceful degradation** — deadlines are enforced at chunk boundaries: a
request that would blow its deadline during the next chunk is harvested
with its best-so-far beam and marked ``degraded``; a reply past its
deadline for any reason is marked too; requests that expire while queued
get an empty degraded reply; sustained overload caps the wave width
(``shed_wave``).

On the card ``device_search._run_chunk`` replays a captured CUDA graph of
a chunk from a chunk shape's second sight on, so the engine serves on the
compacted, graph-replayed path.  Two things follow:

* ``warmup()`` runs real hops.  A chunk captured on ops that never ran
  eagerly can fail under capture, and the reference's warm-up queries
  (empty ranges) are inactive from init here, so they would run no hop.
  The port's warm-up queries are snapshot rows over the full attribute
  range, on throwaway states, and every (bucket, steady chunk) shape is
  run eagerly once and then captured, so a static engine captures
  nothing during traffic.  A wave's first chunk holds the seed iteration
  and always runs eagerly.
* The graph cache keys a chunk by its ``DeviceIndex``'s data pointers,
  so every chunk runs on the engine's serving set (``_ServingSets``): one
  set of device buffers per snapshot capacity (the pow2 row and unique-
  value capacities and the layer count).  A snapshot refresh (after an
  ingest) uploads a new ``DeviceIndex``, which a wave keeps as its own
  snapshot; before a chunk runs, the set takes its wave's snapshot by a
  device-to-device copy when it holds another one.  A refresh within the
  capacity thus keeps every pointer and captures nothing, and a wave in
  flight across it finishes on the snapshot it launched with, as in the
  reference.  A refresh that crosses a capacity allocates a new set,
  whose chunk shapes are captured anew (as JAX compiles there), and the
  sets no wave holds any longer are freed.

Determinism for tests: the clock (``now``) is injectable, and an
**WAL-backed ingest** — ``submit_ingest`` validates rows individually,
logs every micro-batch through the index's attached write-ahead log
(``repro_torch.persist.open_durable``) with ``fsync=False`` and makes them
all durable with one ``sync()`` *before* they enter the ingest queue: the
ack means "recoverable", not "applied".  The scheduler applies queued
batches in order under the ``_wal_replaying`` guard (they are already
logged) and advances ``_applied_lsn`` per batch; a crash at any point
after the ack replays the un-applied suffix at the next ``open_durable``.
Auto-compaction fires only when the queue is empty, so the live apply
order equals the log order and replay stays bitwise.

``EngineFaultPlan`` (``repro_torch.persist.faultfs``) hooks every chunk
and ingest apply.
"""
from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.device_search import (
    _MIN_BUCKET,
    DeviceIndex,
    _compact_rows,
    _init_state,
    _pow2ceil,
    _run_chunk as _run_hop_chunk,
    chunk_schedule_from_hist,
    hop_cfg,
    to_device_index,
    visited_filter_bits_from_hist,
)
from ..monitoring import enabled as tracing_enabled, register_counters, span


# --------------------------------------------------------------------- stats
class ServeStats:
    """Request-lifecycle counters and latency accounting, shared by the
    engine and ``RagPipeline.stats()``.  Latency is admission -> reply, in
    a reservoir of the most recent ``reservoir`` samples."""

    def __init__(self, reservoir: int = 4096):
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.served = 0
        self.degraded = 0
        self.expired = 0  # deadline passed while still queued
        self.ingest_batches = 0
        self.ingest_rows = 0
        self.ingest_rejected_rows = 0
        self.ingest_replayed = 0  # applied from a pre-crash WAL suffix
        self.waves = 0
        self.chunks = 0
        # snapshot refreshes that took a new snapshot; out of ``summary()``,
        # whose keys are the reference engine's (``monitoring.counters()``
        # reads it)
        self.refreshes = 0
        self.shed_waves = 0  # waves assembled at the shed width cap
        self.queue_peak = 0
        self._lat = deque(maxlen=reservoir)
        self._t0: float | None = None
        self._t1: float | None = None

    def note_reply(self, now: float, latency_s: float, degraded: bool) -> None:
        self.served += 1
        if degraded:
            self.degraded += 1
        self._lat.append(latency_s)
        if self._t0 is None:
            self._t0 = now - latency_s
        self._t1 = now

    def latency_percentiles(self) -> dict:
        if not self._lat:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
        q = np.percentile(np.asarray(self._lat), [50, 95, 99]) * 1e3
        return {"p50_ms": float(q[0]), "p95_ms": float(q[1]),
                "p99_ms": float(q[2])}

    def qps(self) -> float:
        if self._t0 is None or self._t1 is None or self._t1 <= self._t0:
            return 0.0
        return self.served / (self._t1 - self._t0)

    def summary(self) -> dict:
        out = {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "served": self.served,
            "degraded": self.degraded,
            "expired": self.expired,
            "degraded_fraction": (self.degraded / self.served
                                  if self.served else 0.0),
            "shed_fraction": (self.rejected / self.submitted
                              if self.submitted else 0.0),
            "waves": self.waves,
            "chunks": self.chunks,
            "shed_waves": self.shed_waves,
            "queue_peak": self.queue_peak,
            "qps": self.qps(),
            "ingest": {
                "batches": self.ingest_batches,
                "rows": self.ingest_rows,
                "rejected_rows": self.ingest_rejected_rows,
                "replayed": self.ingest_replayed,
            },
        }
        out.update(self.latency_percentiles())
        return out


# ------------------------------------------------------------------ requests
@dataclass
class Request:
    """One admitted query request (engine-internal after ``submit``)."""

    rid: int
    query: np.ndarray  # f32[d]
    rng: tuple[float, float]
    k: int
    deadline: float  # absolute clock time; +inf = none
    arrival_t: float


@dataclass
class Reply:
    """The terminal state of a served request.  ``degraded``: answered
    under a reduced hop budget or after its deadline; ``reason`` is None
    for a full-budget in-deadline answer, else ``"deadline"`` (truncated
    in flight, or late) or ``"queue_deadline"`` (expired before execution,
    ids empty)."""

    rid: int
    ids: np.ndarray  # i64[k] external (index) ids, -1 padded
    dists: np.ndarray  # f32[k], +inf padded
    degraded: bool
    reason: str | None
    hops: int
    dc: int
    latency_s: float
    finish_t: float


@dataclass
class Rejected:
    """Backpressure reply: not admitted; retry after ``retry_after`` s."""

    rid: int
    retry_after: float
    queue_len: int


@dataclass
class Ticket:
    rid: int


class IngestResult:
    """Explicit outcome of one ingest call.

    ``accepted`` rows were committed (synchronous path) or logged,
    fsynced and queued for apply (engine path, ``pending=True``);
    ``rejected`` lists ``(row, reason)`` for rows that failed validation.
    ``lsn`` is the last WAL record covering the accepted rows (0: not
    durable).  Array-like over the committed vertex ids."""

    def __init__(self, vids: np.ndarray, accepted: int,
                 rejected: list[tuple[int, str]], lsn: int = 0,
                 pending: bool = False):
        self.vids = np.asarray(vids, dtype=np.int64)
        self.accepted = int(accepted)
        self.rejected = list(rejected)
        self.lsn = int(lsn)
        self.pending = bool(pending)

    def __len__(self) -> int:
        return len(self.vids)

    def __iter__(self):
        return iter(self.vids)

    def __getitem__(self, i):
        return self.vids[i]

    def __array__(self, dtype=None):
        return np.asarray(self.vids, dtype=dtype)

    def __repr__(self) -> str:
        return (f"IngestResult(accepted={self.accepted}, "
                f"rejected={len(self.rejected)}, lsn={self.lsn}, "
                f"pending={self.pending})")


def validate_rows(vectors: np.ndarray, attrs: np.ndarray,
                  dim: int) -> tuple[np.ndarray, list[tuple[int, str]]]:
    """Row-level ingest validation -> (keep mask, rejected rows): a
    half-bad batch yields an explicit accept/reject split.  A wrong vector
    dimension still raises (no row of such a batch is interpretable)."""
    if vectors.ndim != 2 or vectors.shape[1] != dim:
        raise ValueError(
            f"vectors have dimension "
            f"{vectors.shape[-1] if vectors.ndim else 0}, index expects {dim}"
        )
    ok = np.isfinite(attrs)
    rejected = [(int(i), "non-finite attribute") for i in np.flatnonzero(~ok)]
    vok = np.isfinite(vectors).all(axis=1)
    rejected += [(int(i), "non-finite vector component")
                 for i in np.flatnonzero(ok & ~vok)]
    rejected.sort()
    return ok & vok, rejected


# -------------------------------------------------------------------- config
@dataclass
class EngineConfig:
    """Static engine knobs.  Search knobs mirror ``search_batch``; the
    lifecycle knobs bound queue memory (``queue_cap``), wave shape
    (``max_wave``/``max_slots``), overload response (``high_water``,
    ``shed_after``, ``shed_wave``) and ingest fairness (``ingest_share``:
    the fraction of scheduler turns ingest may take while queries are
    pending)."""

    k: int = 10
    width: int = 64
    backend: str = "auto"
    vec_dtype: str = "f32"  # device vector-slab storage mode (serving)
    visited: str = "bitmap"
    visited_bits: int | None = None
    merge: str = "auto"
    max_hops: int | None = None
    adaptive: bool = True  # hist-driven filter + chunk resizing
    chunk: tuple[int, int] = (8, 8)  # cold-start schedule
    hist_window: int = 16  # rolling per-wave histograms
    max_wave: int = 64
    max_slots: int = 256
    queue_cap: int = 512
    high_water: int | None = None  # default queue_cap // 2
    shed_after: int = 3  # consecutive high-pressure observations
    shed_wave: int = 16
    default_timeout_s: float | None = None
    ingest_share: float = 0.5
    ingest_batch: int = 128
    build_backend: str = "numpy"

    def __post_init__(self):
        from ..core.store import VEC_DTYPES

        if self.vec_dtype not in VEC_DTYPES:
            raise ValueError(
                f"vec_dtype must be one of {VEC_DTYPES}, "
                f"got {self.vec_dtype!r}"
            )
        if self.high_water is None:
            self.high_water = max(1, self.queue_cap // 2)
        if not 0.0 <= self.ingest_share <= 1.0:
            raise ValueError("ingest_share must be in [0, 1]")
        if self.queue_cap < 1 or self.max_wave < 1 or self.max_slots < 1:
            raise ValueError("queue_cap/max_wave/max_slots must be >= 1")


class _ServingSets:
    """The device buffers every hop chunk of the engine runs on: one set
    per snapshot capacity, so the graphs captured on a set stay valid
    across refreshes (see the module docstring).  ``bind(src)`` returns
    the set of ``src``'s capacity holding ``src``'s tensors, copying them
    in (device to device) when the set holds another snapshot."""

    def __init__(self):
        self._sets: dict = {}  # capacity -> [buffers, snapshot held]
        self.copies = 0  # copy-ins of a snapshot into an existing set

    @staticmethod
    def _capacity(di: DeviceIndex) -> tuple:
        return tuple((tuple(t.shape), t.dtype) for t in di)

    def bind(self, src: DeviceIndex) -> DeviceIndex:
        cap = self._capacity(src)
        entry = self._sets.get(cap)
        if entry is None:
            entry = self._sets[cap] = [
                DeviceIndex(*(t.clone() for t in src)), src]
        elif entry[1] is not src:
            with span("repro_torch.chunk.bind") as sp:
                for dst, t in zip(entry[0], src):
                    dst.copy_(t)
                if tracing_enabled():
                    sp.set(bytes=sum(t.numel() * t.element_size()
                                     for t in src))
            entry[1] = src
            self.copies += 1
        return entry[0]

    def retain(self, live: list) -> None:
        """Free the sets of capacities no snapshot in ``live`` has."""
        keep = {self._capacity(di) for di in live}
        for cap in [c for c in self._sets if c not in keep]:
            del self._sets[cap]

    def stats(self) -> dict:
        """Sets held, their device bytes, and the copy-ins so far."""
        return {"sets": len(self._sets),
                "bytes": sum(t.numel() * t.element_size()
                             for buf, _ in self._sets.values() for t in buf),
                "copies": self.copies}


@dataclass(eq=False)  # identity equality: fields hold tensors
class _Wave:
    """Slot-based in-flight state of one admitted wave."""

    st: object  # HopState (device)
    cfg: object  # HopCfg
    di: object  # DeviceIndex the wave was launched against (its snapshot)
    ids_map: np.ndarray  # snapshot id -> external id
    reqs: list  # admitted requests (stable for the wave's lifetime)
    orig: np.ndarray  # slot -> index into reqs, -1 = retired/padding
    dl: np.ndarray  # f64[slots] absolute deadlines (+inf = none)
    chunk: tuple[int, int]
    next_h: int
    t_planned: int = 0
    shed: bool = False  # assembled under the shed width cap
    wid: int = 0  # the wave's number (its spans' id)


# -------------------------------------------------------------------- engine
_ENGINES = weakref.WeakSet()  # live engines, for ``monitoring.counters()``


def _engine_counters() -> dict:
    live = list(_ENGINES)
    stats = {id(e.stats): e.stats for e in live}.values()  # may be shared
    return {"refreshes": sum(s.refreshes for s in stats),
            "serving_set_copies": sum(e._sets.copies for e in live)}


register_counters("lifecycle.ServeEngine", _engine_counters)


class ServeEngine:
    """Single-host serve engine (see the module docstring).  Step-driven:
    ``submit``/``submit_ingest`` enqueue, ``step()`` advances the
    scheduler by one turn (at most one ingest apply and one hop chunk) and
    returns the replies it produced, ``drain()`` steps until idle.

    ``index`` enables ingest and snapshot refresh; a bare ``snapshot``
    serves queries only.  ``device=None`` serves on the CUDA card (raises
    without CUDA); tests pass ``device="cpu"``.  When the index has a
    write-ahead log attached, ingest admission is durable: acked batches
    survive any crash.  The rows the index's recovery replayed from its
    log are counted once, by the first engine over it
    (``stats.ingest_replayed``).
    """

    def __init__(self, index=None, snapshot=None,
                 config: EngineConfig | None = None, now=None,
                 fault_plan=None, stats: ServeStats | None = None,
                 device=None):
        if index is None and snapshot is None:
            raise ValueError("ServeEngine needs an index or a snapshot")
        self.index = index
        self.config = config or EngineConfig()
        self.stats = stats or ServeStats()
        self.fault_plan = fault_plan
        self.device = resolve_device(device)
        self._now = now or time.monotonic
        if index is not None:
            self.stats.ingest_replayed += index._replayed_rows
            index._replayed_rows = 0
        self._snap = snapshot
        # key by the snapshot's OWN stamp (not index.mutations): a handed-in
        # snapshot may be stale, and the first wave must notice and refresh
        self._snap_key = snapshot.stamp if snapshot is not None else None
        self._di = (
            to_device_index(snapshot, vec_dtype=self.config.vec_dtype,
                            device=self.device)
            if snapshot is not None else None
        )
        self._queue: deque[Request] = deque()
        self._ingest_q: deque[tuple[int | None, np.ndarray, np.ndarray]] = (
            deque()
        )
        self._waves: list[_Wave] = []
        self._rr = 0  # round-robin cursor over in-flight waves
        self._next_rid = 0
        self._ingest_credit = 0.0
        self._pressure = 0  # consecutive over-high-water observations
        self._recent_hists: deque = deque(maxlen=self.config.hist_window)
        self._sets = _ServingSets()
        self._hop_s = 0.0  # EWMA wall seconds per hop chunk-iteration
        self._wave_s = 0.0  # EWMA wall seconds per executed chunk
        _ENGINES.add(self)

    # ---------------------------------------------------------- introspection
    @property
    def queue_len(self) -> int:
        return len(self._queue)

    @property
    def pending_ingest(self) -> int:
        return len(self._ingest_q)

    @property
    def in_flight(self) -> int:
        return sum(int(np.sum(w.orig >= 0)) for w in self._waves)

    @property
    def idle(self) -> bool:
        return not (self._queue or self._waves or self._ingest_q)

    def overloaded(self) -> bool:
        return self._pressure >= self.config.shed_after

    def hop_histogram(self) -> np.ndarray | None:
        """Rolling hop histogram over the last ``hist_window`` waves."""
        if not self._recent_hists:
            return None
        H = max(h.shape[0] for h in self._recent_hists)
        out = np.zeros(H, np.int64)
        for h in self._recent_hists:
            out[: h.shape[0]] += h
        return out

    def engine_stats(self) -> dict:
        """Live scheduler state + the ``ServeStats`` summary."""
        out = self.stats.summary()
        out.update(
            queue_len=self.queue_len,
            in_flight=self.in_flight,
            pending_ingest=self.pending_ingest,
            overloaded=self.overloaded(),
            applied_lsn=(self.index._applied_lsn
                         if self.index is not None else 0),
            chunk_schedule=list(self._chunk_schedule()),
            visited_bits=self._visited_bits(),
        )
        return out

    def serving_set_stats(self) -> dict:
        """The serving sets (``_ServingSets.stats``): sets held, their
        device bytes, and the snapshot copy-ins so far."""
        return self._sets.stats()

    # -------------------------------------------------------------- admission
    def submit(self, query: np.ndarray, rng, k: int | None = None,
               timeout_s: float | None = None):
        """Admit one query request -> a ``Ticket``, or a ``Rejected``
        carrying the retry-after estimate."""
        with span("repro_torch.engine.submit", id=self._next_rid):
            now = self._now()
            cfg = self.config
            self.stats.submitted += 1
            rid = self._next_rid
            self._next_rid += 1
            qlen = len(self._queue)
            if qlen >= cfg.queue_cap:
                self.stats.rejected += 1
                self._pressure += 1
                return Rejected(rid=rid, retry_after=self._retry_after(),
                                queue_len=qlen)
            if qlen >= cfg.high_water:
                self._pressure += 1
            elif qlen < cfg.high_water // 2:
                self._pressure = max(0, self._pressure - 1)
            if timeout_s is None:
                timeout_s = cfg.default_timeout_s
            deadline = now + timeout_s if timeout_s is not None else np.inf
            k = int(k) if k is not None else cfg.k
            if k > cfg.k:
                raise ValueError(f"k={k} exceeds the engine's configured "
                                 f"k={cfg.k} (beam harvest width)")
            self._queue.append(Request(
                rid=rid, query=np.asarray(query, np.float32),
                rng=(float(rng[0]), float(rng[1])), k=k, deadline=deadline,
                arrival_t=now,
            ))
            self.stats.admitted += 1
            self.stats.queue_peak = max(self.stats.queue_peak,
                                        len(self._queue))
            return Ticket(rid=rid)

    #: retry_after ceiling: a hint above this means the EWMA was poisoned
    #: (virtual-clock jump, pathological chunk); clients should re-probe
    RETRY_AFTER_MAX_S = 30.0
    _RETRY_AFTER_COLD_S = 0.05  # one-chunk floor before any chunk ran

    def _retry_after(self) -> float:
        """Backpressure hint: the time to drain half the queue at the
        observed service rate (chunk EWMA), floored at one chunk; always a
        bounded positive float (a cold-start EWMA is 0, a virtual-clock
        jump can make it non-finite)."""
        per_wave = self._wave_s
        if not np.isfinite(per_wave) or per_wave <= 0.0:
            per_wave = self._RETRY_AFTER_COLD_S
        waves_ahead = (len(self._queue) / (2.0 * self.config.max_wave)
                       + len(self._waves))
        hint = max(per_wave, waves_ahead * per_wave)
        if not np.isfinite(hint) or hint <= 0.0:
            hint = self._RETRY_AFTER_COLD_S
        return float(min(hint, self.RETRY_AFTER_MAX_S))

    # ----------------------------------------------------------------- ingest
    def submit_ingest(self, vectors: np.ndarray, attrs) -> IngestResult:
        """Admit an ingest batch: per-row validation, WAL group commit
        (log every micro-batch of ``ingest_batch`` rows, one fsync), then
        queue for apply under the scheduler (``pending=True``).  With a
        log attached the result is the durability ack (``lsn``: the last
        record covering the accepted rows) — accepted rows survive any
        later crash; without one it means "queued" (``lsn`` 0)."""
        if self.index is None:
            raise RuntimeError(
                "ingest needs a live index (engine was built from a bare "
                "snapshot; recover the index first)"
            )
        with span("repro_torch.engine.submit_ingest") as sp:
            vectors = np.asarray(vectors, np.float32)
            if vectors.ndim == 1:
                vectors = vectors.reshape(1, -1)
            attrs = np.asarray(attrs, np.float64).reshape(-1)
            if len(vectors) != len(attrs):
                raise ValueError(
                    f"{len(vectors)} vectors vs {len(attrs)} attrs")
            keep, rejected = validate_rows(vectors, attrs, self.index.dim)
            self.stats.ingest_rejected_rows += len(rejected)
            vectors, attrs = vectors[keep], attrs[keep]
            sp.set(rows=len(attrs))
            wal = self.index._wal
            lsn = self.index._applied_lsn
            bs = self.config.ingest_batch
            staged = []
            for s in range(0, len(attrs), bs):
                vs, as_ = vectors[s : s + bs], attrs[s : s + bs]
                if wal is not None:
                    # group commit: append now, one fsync below acks them
                    lsn = wal.log_insert(vs, as_,
                                         backend=self.config.build_backend,
                                         device_width=None, shards=None,
                                         fsync=False)
                    staged.append((lsn, vs, as_))
                else:
                    staged.append((None, vs, as_))
            if wal is not None and staged:
                wal.sync()  # durability barrier: everything above is acked
            self._ingest_q.extend(staged)
            self.stats.ingest_batches += len(staged)
            self.stats.ingest_rows += len(attrs)
            return IngestResult(
                vids=np.empty(0, np.int64), accepted=len(attrs),
                rejected=rejected, lsn=lsn if wal is not None else 0,
                pending=True,
            )

    def _apply_ingest_one(self) -> None:
        """Apply the oldest queued (already logged) ingest micro-batch.
        It stays queued until the apply commits, so a fault-plan crash
        here loses nothing: the batch is in the log and replays."""
        if self.fault_plan is not None:
            self.fault_plan.on_ingest_apply()
        lsn, vs, as_ = self._ingest_q[0]
        idx = self.index
        # the batch's id: its LSN, else its number among those admitted
        seq = lsn if lsn is not None else \
            self.stats.ingest_batches - len(self._ingest_q)
        with span("repro_torch.engine.ingest_apply", id=seq, rows=len(as_)):
            if lsn is not None:
                # already logged at admission: the apply must not re-log
                idx._wal_replaying = True
                try:
                    idx.insert_batch(vs, as_, batch_size=max(len(as_), 1),
                                     backend=self.config.build_backend)
                finally:
                    idx._wal_replaying = False
                idx._applied_lsn = lsn
            else:
                idx.insert_batch(vs, as_, batch_size=max(len(as_), 1),
                                 backend=self.config.build_backend)
            self._ingest_q.popleft()
            if not self._ingest_q:
                # the cadence check is deferred until the queue is empty so
                # a triggered COMPACT record lands after every already-
                # logged insert — live apply order must equal log order for
                # replay
                idx._maybe_auto_compact()

    # -------------------------------------------------------------- scheduler
    def step(self) -> list[Reply]:
        """One scheduler turn: expire stale queued requests, give ingest
        its fair share, assemble a wave if there is capacity, run one hop
        chunk of one in-flight wave.  Returns the replies produced."""
        with span("repro_torch.engine.step"):
            now = self._now()
            replies: list[Reply] = []
            self._expire_queued(now, replies)
            if self._ingest_q:
                self._ingest_credit += self.config.ingest_share
                if self._ingest_credit >= 1.0 or not (self._queue
                                                      or self._waves):
                    self._ingest_credit = max(0.0, self._ingest_credit - 1.0)
                    self._apply_ingest_one()
            free = self.config.max_slots - self.in_flight
            # batching policy: while waves are in flight, let arrivals
            # accumulate into a full-width wave; once the engine is idle,
            # take whatever is queued (cannot starve: when the last wave
            # retires the next step assembles a partial wave)
            full = self.config.shed_wave if self.overloaded() else \
                self.config.max_wave
            if self._queue and free > 0 and (
                not self._waves or len(self._queue) >= full
            ):
                self._assemble_wave(free)
            if self._waves:
                replies.extend(self._run_chunk())
            return replies

    def drain(self, max_steps: int = 1_000_000) -> list[Reply]:
        """Step until idle; the step bound turns a scheduler deadlock into
        a loud failure instead of a hang."""
        replies: list[Reply] = []
        for _ in range(max_steps):
            if self.idle:
                return replies
            replies.extend(self.step())
        raise RuntimeError(
            f"engine failed to drain within {max_steps} steps "
            f"(queue={self.queue_len}, in_flight={self.in_flight}, "
            f"ingest={self.pending_ingest})"
        )

    # ------------------------------------------------------------- internals
    def _expire_queued(self, now: float, replies: list[Reply]) -> None:
        if not self._queue:
            return
        with span("repro_torch.engine.expire") as sp:
            keep: deque[Request] = deque()
            for req in self._queue:
                if req.deadline < now:
                    self.stats.expired += 1
                    replies.append(self._reply(
                        req, np.full(req.k, -1, np.int64),
                        np.full(req.k, np.inf, np.float32), hops=0, dc=0,
                        now=now, degraded=True, reason="queue_deadline",
                    ))
                else:
                    keep.append(req)
            sp.set(expired=len(self._queue) - len(keep))
            self._queue = keep

    def _refresh_snapshot(self) -> None:
        if self.index is None:
            if self._snap is None:
                raise RuntimeError("no serving snapshot")
            return
        key = self.index.mutations
        if self._di is None or self._snap is None or self._snap_key != key:
            from ..core.snapshot import take_snapshot

            with span("repro_torch.engine.refresh"):
                self._snap = take_snapshot(self.index, prev=self._snap)
                with span("repro_torch.snapshot.upload"):
                    self._di = to_device_index(
                        self._snap, vec_dtype=self.config.vec_dtype,
                        device=self.device,
                    )
                self._snap_key = key
                self._sets.retain([self._di] + [w.di for w in self._waves])
            self.stats.refreshes += 1

    def _visited_bits(self) -> int | None:
        cfg = self.config
        if cfg.visited != "hash":
            return None
        if cfg.adaptive:
            hist = self.hop_histogram()
            if hist is not None and self._snap is not None:
                return visited_filter_bits_from_hist(hist, self._snap.m)
        return cfg.visited_bits  # None = worst-case budget sizing

    def _chunk_schedule(self) -> tuple[int, int]:
        if self.config.adaptive:
            hist = self.hop_histogram()
            if hist is not None:
                return chunk_schedule_from_hist(hist)
        return self.config.chunk

    def _wave_cfg(self, snap):
        cfg = self.config
        return hop_cfg(
            k=cfg.k, width=cfg.width, m=snap.m, o=snap.o,
            metric="l2" if snap.metric == "l2" else "cosine",
            max_hops=cfg.max_hops, backend=cfg.backend,
            visited=cfg.visited, visited_bits=self._visited_bits(),
            merge=cfg.merge,
        )

    def warmup(self) -> float:
        """Run every chunk shape the scheduler can assemble under the
        current schedule before traffic: each pow2 wave bucket up to
        ``max_wave`` x {first chunk, steady chunk}, the steady chunk twice
        from the same state at ``t = h0`` (its first sight runs eagerly,
        the second captures its CUDA graph on the card; where ``h0 + h1``
        passes the hop cap, traffic never replays that chunk either).  The
        queries are snapshot rows over the snapshot's full attribute range,
        so the hops really run (see the module docstring).  Adaptive
        engines can still meet new chunk lengths or filter sizes as the
        histogram shifts; a static one captures nothing after this.
        Touches no scheduler state (queue, waves, histograms; of the stats
        only ``refreshes``, where it takes the first snapshot) and returns
        the wall seconds spent."""
        t0 = time.perf_counter()
        self._refresh_snapshot()
        snap, di = self._snap, self._sets.bind(self._di)
        wcfg = self._wave_cfg(snap)
        h0, h1 = self._chunk_schedule()
        buckets, B = [], _MIN_BUCKET
        while B < self.config.max_wave:
            buckets.append(B)
            B *= 2
        buckets.append(_pow2ceil(max(self.config.max_wave, _MIN_BUCKET)))
        n = snap.vectors.shape[0]
        rows = np.arange(buckets[-1]) * max(n // buckets[-1], 1) % n
        qp = torch.as_tensor(np.asarray(snap.vectors[rows], np.float32),
                             device=self.device)
        lo, hi = float(np.min(snap.attrs)), float(np.max(snap.attrs))
        rp = torch.tensor([[lo, hi]], dtype=torch.float32,
                          device=self.device).repeat(buckets[-1], 1)
        for B in buckets:
            st = _init_state(di, qp[:B], rp[:B], wcfg)
            st = _run_hop_chunk(di, st, wcfg, h0)  # the seed chunk
            for _ in range(2):
                _run_hop_chunk(di, st, wcfg, h1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _assemble_wave(self, free: int) -> None:
        cfg = self.config
        shed = self.overloaded()
        cap = cfg.shed_wave if shed else cfg.max_wave
        take = min(cap, free, len(self._queue))
        if take <= 0:
            return
        self._refresh_snapshot()
        wid = self.stats.waves
        with span("repro_torch.engine.assemble", id=wid, rows=take) as sp:
            snap, di = self._snap, self._di
            reqs = [self._queue.popleft() for _ in range(take)]
            if tracing_enabled():  # each request's wait since admission
                now = self._now()
                sp.set(waits_s=np.array([now - r.arrival_t for r in reqs]))
            wcfg = self._wave_cfg(snap)
            chunk = self._chunk_schedule()
            Bp = _pow2ceil(max(take, _MIN_BUCKET))
            qp = np.zeros((Bp, snap.vectors.shape[1]), np.float32)
            rp = np.tile(np.asarray([[1.0, 0.0]], np.float32), (Bp, 1))
            dl = np.full(Bp, np.inf)
            for i, r in enumerate(reqs):
                qp[i] = r.query
                rp[i] = r.rng
                dl[i] = r.deadline
            st = _init_state(di, torch.from_numpy(qp).to(self.device),
                             torch.from_numpy(rp).to(self.device), wcfg)
            orig = np.concatenate(
                [np.arange(take), np.full(Bp - take, -1)]
            ).astype(np.int64)
            self._waves.append(_Wave(
                st=st, cfg=wcfg, di=di, ids_map=snap.ids_map, reqs=reqs,
                orig=orig, dl=dl, chunk=chunk, next_h=chunk[0], shed=shed,
                wid=wid,
            ))
        self.stats.waves += 1
        if shed:
            self.stats.shed_waves += 1

    def _run_chunk(self) -> list[Reply]:
        if self.fault_plan is not None:
            self.fault_plan.on_chunk()
        w = self._waves[self._rr % len(self._waves)]
        h = w.next_h
        with span("repro_torch.engine.chunk", id=w.wid, bucket=len(w.orig),
                  h=h):
            replies = self._chunk_of(w, h)
        self._rr += 1
        return replies

    def _chunk_of(self, w: _Wave, h: int) -> list[Reply]:
        """Run one chunk of ``h`` hops of wave ``w``, reply to the requests
        it finished (or whose deadline cannot afford the next chunk), and
        compact the survivors into their bucket."""
        t0 = self._now()
        w.st = _run_hop_chunk(self._sets.bind(w.di), w.st, w.cfg, h)
        with span("repro_torch.chunk.sync"):
            act = w.st.active.cpu().numpy()  # the chunk-boundary sync point
        now = self._now()
        self.stats.chunks += 1
        w.t_planned += h
        dt = max(now - t0, 0.0)
        if np.isfinite(dt):  # a virtual-clock jump must not poison the EWMAs
            a = 0.3  # EWMA weight: recent chunks dominate the estimates
            self._hop_s = (1 - a) * self._hop_s + a * (dt / h) \
                if self._hop_s else dt / h
            self._wave_s = (1 - a) * self._wave_s + a * dt \
                if self._wave_s else dt

        real = w.orig >= 0
        # the host-side plan, not st.t: a replayed chunk always runs h hops
        budget_out = w.t_planned >= w.cfg.max_hops + 1
        finished = real & ~act
        # deadline check: a request that cannot afford the NEXT chunk is
        # harvested now with its best-so-far beam; round-robin means a wave
        # waits len(waves) turns for its next chunk
        est_next = self._hop_s * w.chunk[1] * max(len(self._waves), 1)
        blown = real & act & (w.dl < now + est_next)
        harvest = finished | blown | (real & act & budget_out)
        replies: list[Reply] = []
        if harvest.any():
            with span("repro_torch.chunk.harvest", id=w.wid) as sp:
                res_i = w.st.res_i.cpu().numpy()
                res_d = w.st.res_d.cpu().numpy()
                dc = w.st.dc.cpu().numpy()
                hops = w.st.hops.cpu().numpy()
                hist = np.bincount(hops[harvest], minlength=1)
                self._recent_hists.append(hist.astype(np.int64))
                for slot in np.flatnonzero(harvest):
                    req = w.reqs[w.orig[slot]]
                    truncated = bool(act[slot]) and bool(blown[slot])
                    late = now > req.deadline
                    ids = res_i[slot, : req.k]
                    mapped = np.where(
                        ids >= 0, w.ids_map[np.clip(ids, 0, None)], -1
                    ).astype(np.int64)
                    replies.append(self._reply(
                        req, mapped, res_d[slot, : req.k].copy(),
                        hops=int(hops[slot]), dc=int(dc[slot]), now=now,
                        degraded=truncated or late,
                        reason="deadline" if (truncated or late) else None,
                    ))
                sp.set(replies=len(replies))
        live = real & act & ~harvest
        nlive = int(np.sum(live))
        if nlive == 0:
            self._waves.remove(w)
            return replies
        # pow2 buckets (not the 1.5x granularity of _drive_chunked): engine
        # waves are narrow, so fewer chunk shapes beats tighter padding
        Bn = min(len(w.orig), _pow2ceil(max(nlive, _MIN_BUCKET)))
        rows = np.flatnonzero(live)
        if Bn < len(w.orig):  # bucket shrinks: gather the survivors
            with span("repro_torch.chunk.compact", id=w.wid,
                      bucket_from=len(w.orig), bucket_to=Bn):
                idx = np.concatenate(
                    [rows, np.full(Bn - nlive, rows[0])]
                )
                w.st = _compact_rows(
                    w.st, torch.as_tensor(idx, device=self.device), nlive)
                w.orig = np.where(np.arange(Bn) < nlive, w.orig[idx], -1)
                w.dl = w.dl[idx]
        else:  # same bucket: just retire the harvested slots
            w.orig[harvest] = -1
        w.next_h = w.chunk[1]
        return replies

    def _reply(self, req: Request, ids: np.ndarray, dists: np.ndarray,
               hops: int, dc: int, now: float, degraded: bool,
               reason: str | None) -> Reply:
        lat = max(now - req.arrival_t, 0.0)
        self.stats.note_reply(now, lat, degraded)
        return Reply(rid=req.rid, ids=ids, dists=dists, degraded=degraded,
                     reason=reason, hops=hops, dc=dc, latency_s=lat,
                     finish_t=now)
