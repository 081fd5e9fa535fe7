"""closed_loop: closed-loop readers, with an ingest stream at a stated
rate beside them where the mix has one.

* ``clients`` readers each hold one request outstanding: a reader sends
  its next query as soon as the ``step()`` that returned its reply
  returns, taking the ``pool``'s queries in turn.  A rejected request is
  timed as +inf and its reader sends again at the next step.
* ``ingest`` (or null): ``{"rows_per_s", "batch_rows", "warm_batches",
  "fresh_every"}``.  Micro-batches of ``batch_rows`` rows arrive on a
  fixed schedule, one every ``batch_rows / rows_per_s`` seconds from the
  window's start, whatever the engine is doing, and are sent through
  ``submit_ingest`` at the first step after their arrival; a batch is
  timed from its arrival to the step after which the engine no longer
  holds it (applied, so searchable).  ``warm_batches`` are applied in
  set-up.  Every ``fresh_every``-th query of the pool ranges over the
  attributes of the rows the run can ingest, so a read in the window can
  return rows applied in it.
* ``probe`` (or null): ``{"queries"}``.  Once the window has closed and
  every batch sent is applied, ``queries`` more queries (the same share
  over the ingested rows) go through the engine from ``clients`` readers;
  the reference holds them against the base and every ingested row.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from wowbench import data
from wowbench.loadgen import HARNESS_KEYS, Log

KEYS = {"clients", "pool", "fractions_log2", "ingest", "probe"}
INGEST_KEYS = {"rows_per_s", "batch_rows", "warm_batches", "fresh_every"}


def check_mix(mix: dict) -> None:
    unknown = set(mix) - KEYS - HARNESS_KEYS
    missing = KEYS - set(mix)
    ing = mix.get("ingest") or {}
    unknown |= set(ing) - INGEST_KEYS
    missing |= INGEST_KEYS - set(ing) if ing else set()
    if unknown or missing:
        raise ValueError(f"closed_loop mix: unknown keys {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    if mix["engine"]["queue_cap"] < mix["clients"]:
        raise ValueError("closed_loop mix: queue_cap below the client count "
                         "would reject requests of a closed loop")
    if ing and mix["engine"].get("ingest_batch") != ing["batch_rows"]:
        raise ValueError("closed_loop mix: the engine's ingest_batch must "
                         "be batch_rows, one apply a micro-batch")
    if mix["probe"] and not ing:
        raise ValueError("closed_loop mix: a probe follows an ingest stream")


class Readers:
    """``clients`` closed-loop readers over a query pool; with ``limit``
    they send that many requests in all."""

    def __init__(self, eng, queries, ranges, clients, clock, span,
                 limit=None):
        self.eng, self.queries, self.ranges = eng, queries, ranges
        self.clients, self.clock, self.span = clients, clock, span
        self.limit = limit
        self.log = Log()
        self._next_q = 0
        self._live: dict = {}  # rid -> request number in the log

    def _send(self) -> None:
        if self.limit is not None and self._next_q >= self.limit:
            return
        qi = self._next_q % len(self.queries)
        self._next_q += 1
        n = self.log.add(qi, self.clock())
        with self.span("submit"):
            out = self.eng.submit(self.queries[qi], self.ranges[qi])
        if hasattr(out, "retry_after"):  # Rejected: send again next step
            self.log.rejected += 1
            self._want += 1
        else:
            self._live[out.rid] = n

    def start(self) -> None:
        self._want = 0
        for _ in range(self.clients):
            self._send()

    def replied(self, replies, t: float, sending: bool) -> None:
        """Record ``replies`` (returned at ``t``); while ``sending``, their
        readers send again."""
        for r in replies:
            n = self._live.pop(r.rid, None)
            if n is not None:
                self.log.reply(n, r, t)
                self._want += 1
        if sending:
            want, self._want = self._want, 0
            for _ in range(want):
                self._send()

    @property
    def outstanding(self) -> int:
        return len(self._live)


class Traffic:
    """The mix against one engine (see the module docstring)."""

    def __init__(self, eng, index, cfg, mix, base, seed, seconds,
                 clock=time.perf_counter, span=None, device="cpu"):
        self.eng, self.index, self.mix = eng, index, mix
        self.clock = clock
        self.span = span or (lambda name: contextlib.nullcontext())
        self.n = len(base.attrs)
        g = data.generator(seed, device)
        fr = data.mixed_fractions(*mix["fractions_log2"])
        ing = self.ing = mix["ingest"]
        fresh_every, fresh = 0, None
        if ing:
            self.rows = ing["batch_rows"]
            self.period = ing["batch_rows"] / ing["rows_per_s"]
            batches = ing["warm_batches"] + int(seconds / self.period) + 2
            new = data.make_ingest(base, batches * self.rows, g)
            self.ingest_vectors = new.vectors.cpu().numpy()
            self.ingest_attrs = new.attrs.cpu().numpy()
            fresh_every, fresh = ing["fresh_every"], new.attrs
        q = data.make_queries(base, mix["pool"], fr, g, fresh_every, fresh)
        self.queries = q.vectors.cpu().numpy()
        self.ranges = q.ranges.cpu().numpy()
        self.fresh = np.zeros(len(self.queries), bool)
        if fresh_every:
            self.fresh[fresh_every - 1::fresh_every] = True
        if mix["probe"]:
            p = data.make_queries(base, mix["probe"]["queries"], fr, g,
                                  fresh_every, fresh)
            self.probe_queries = p.vectors.cpu().numpy()
            self.probe_ranges = p.ranges.cpu().numpy()
        self.reads = Readers(eng, self.queries, self.ranges, mix["clients"],
                             clock, self.span)
        self.probe = None
        self.sent = 0  # ingest rows sent (set-up's too)
        self.batches: list = []  # window batches: [arrival, applied]
        self.rows_missing = None

    # ------------------------------------------------------------- set-up
    def _submit(self) -> None:
        s = self.sent
        with self.span("submit_ingest"):
            self.eng.submit_ingest(self.ingest_vectors[s:s + self.rows],
                                   self.ingest_attrs[s:s + self.rows])
        self.sent += self.rows

    def warm(self) -> None:
        """Apply the warm-up micro-batches: the first growth of the
        arenas and serving sets past the base falls in set-up."""
        if self.ing:
            for _ in range(self.ing["warm_batches"]):
                self._submit()
            self.eng.drain()

    # ------------------------------------------------------------- window
    def start(self) -> None:
        self.t0 = self.clock()
        self.next_arrival = self.t0
        self.searches0 = self.index.build_stats.searches
        self.reads.start()
        self._ingest(self.t0, sending=True)

    def _ingest(self, t: float, sending: bool) -> None:
        if not self.ing:
            return
        done = len(self.batches) - self.eng.pending_ingest
        for b in self.batches:
            if done <= 0:
                break
            if b[1] is None:
                b[1] = t
            done -= 1
        while (sending and self.next_arrival <= t
               and self.sent + self.rows <= len(self.ingest_attrs)):
            self._submit()
            self.batches.append([self.next_arrival, None])
            self.next_arrival += self.period

    def tick(self, sending: bool = True) -> None:
        with self.span("step"):
            replies = self.eng.step()
        t = self.clock()
        self.reads.replied(replies, t, sending)
        self._ingest(t, sending)

    def close(self, t_close: float, limit_s: float = 60.0) -> None:
        """The window closed at ``t_close``: no reader or batch is sent
        again; every request and batch in the engine is finished (or
        ``limit_s`` passes); then the probe, if any, within ``limit_s``
        more."""
        self.t_close = t_close
        self.window_rows = self.rows * sum(
            1 for b in self.batches if b[1] is not None) if self.ing else 0
        self.window_searches = (self.index.build_stats.searches
                                - self.searches0)
        t_end = self.clock() + limit_s
        while ((self.reads.outstanding or self.eng.pending_ingest)
               and not self.eng.idle and self.clock() < t_end):
            self.tick(sending=False)
        if not self.ing:
            return
        self.rows_missing = self.n + self.sent - len(self.index)
        if self.mix["probe"]:
            t_end = self.clock() + limit_s
            self.probe = Readers(self.eng, self.probe_queries,
                                 self.probe_ranges, self.mix["clients"],
                                 self.clock, self.span,
                                 limit=len(self.probe_queries))
            self.probe.start()
            while self.probe.outstanding and self.clock() < t_end:
                self.probe.replied(self.eng.step(), self.clock(), True)

    # ------------------------------------------------------------- after
    def extra_rows(self):
        """The rows the run ingested -> (vectors f32[I, d], attrs f64[I])."""
        if not self.ing:
            return None
        return self.ingest_vectors[:self.sent], self.ingest_attrs[:self.sent]

    def replies(self) -> list[dict]:
        """What the reference judges: the window's replies, and the
        probe's where the mix has one (an empty log if it never ran).
        ``recall`` marks the queries whose exact answer does not depend
        on when they ran (ranges over the base only)."""
        out = [{"prefix": "", "log": self.reads.log, "queries": self.queries,
                "ranges": self.ranges, "recall": ~self.fresh}]
        if self.mix["probe"]:
            out.append({"prefix": "probe_",
                        "log": self.probe.log if self.probe else Log(),
                        "queries": self.probe_queries,
                        "ranges": self.probe_ranges,
                        "recall": np.ones(len(self.probe_queries), bool)})
        return out

    def checks(self) -> dict:
        if self.rows_missing is None:
            return {}
        return {"rows_missing": [int(self.rows_missing), 0]}

    def readings(self) -> dict:
        """The window's requests and, with ingest, its batches."""
        out = {"requests": self.reads.log.arrays(), "ingest": None}
        if self.ing:
            arr = np.asarray([b[0] for b in self.batches], np.float64)
            app = np.asarray([np.inf if b[1] is None else b[1]
                              for b in self.batches], np.float64)
            out["ingest"] = {"rows": self.window_rows,
                             "searches": self.window_searches,
                             "arrival": arr, "lag_s": app - arr}
        return out
