"""Replicated serving cluster: routing, failover, rolling restarts (the
port of ``repro.serve.cluster``).

A `Cluster` owns N `ClusterMember`s (one durable root each), wires them
over an injectable transport (`InProcTransport` by default, optionally
fault-wrapped), and drives everything step-by-step from one thread — the
same determinism contract as `ServeEngine`: the test harness owns the
clock and every schedule replays exactly.

Roles.  Exactly one member is the *primary*: it owns ingest (its
`ReplicatedWal` makes every ingest ack quorum-durable) and ships WAL
records to the replicas.  Replicas apply the stream under the replay
guard and serve read traffic from their own engine — queries route
round-robin across every admitted member, so reads scale out and survive
any single member.

Failover.  `step()` watches the replicas' heartbeat clocks; once every
live replica has timed out on the primary, the highest-durable-LSN
replica is promoted (epoch bumped strictly above everything observed,
stamped into its log before any new-term record), the other replicas
re-point at it, and every query that was routed to the dead member is
resubmitted elsewhere — callers see a reply (possibly degraded), never
an error.

Rolling restart.  `rolling_restart()` cycles every member one at a time
through drain -> checkpoint -> shutdown -> restart-as-replica ->
catch-up -> readmit; the primary goes last behind a planned handover
(drain, promote the most-durable replica, rejoin as a replica).  The
engines' backpressure/degraded machinery absorbs the transition: at
least ``quorum`` members keep serving at every instant.

Device.  ``Cluster(device=None)`` runs every member on the CUDA card (and
raises without CUDA): the primary's index, every replica's index and every
member's `ServeEngine`, so each member's hops and each replicated
device-build apply launch the ``gather_norm_dot`` kernel.  Tests pass
``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from .. import resolve_device
from ..persist import checkpoint as _ckpt
from ..persist.faultfs import OsIO
from ..persist.recovery import open_durable
from ..persist.replicate import (
    InProcEndpoint,
    InProcTransport,
    PrimaryReplicator,
    ReplicaReplicator,
)
from .lifecycle import EngineConfig, Rejected, Reply, ServeEngine, Ticket


@dataclass
class ClusterTicket:
    """Admission handle for a routed query: ``crid`` is cluster-global
    (stable across resubmission after a member death)."""

    crid: int
    node: str


@dataclass
class ClusterReply:
    """One finished query: the member that served it plus its `Reply`."""

    crid: int
    node: str
    reply: Reply


@dataclass
class ClusterMember:
    node_id: str
    root: str
    endpoint: object
    replicator: object  # PrimaryReplicator | ReplicaReplicator | None
    engine: ServeEngine | None
    role: str  # "primary" | "replica" | "down"
    admitted: bool  # eligible for new query routing


class Cluster:
    """See the module docstring.  ``roots`` maps node id -> durable root
    directory (a list gets ids ``n0..n{k-1}``; the first entry starts as
    primary).  ``quorum`` counts the primary and defaults to a majority.
    ``create`` holds `WoWIndex` kwargs for a fresh primary root.
    ``device`` (None = the CUDA card) is every member's device."""

    def __init__(self, roots, create: dict | None = None,
                 config: EngineConfig | None = None, quorum: int | None = None,
                 transport=None, io: OsIO | None = None, now=None,
                 heartbeat_s: float = 0.05, heartbeat_timeout_s: float = 0.5,
                 segment_bytes: int = 4 << 20,
                 compact_threshold: float | None = None, device=None):
        if not isinstance(roots, dict):
            roots = {f"n{i}": r for i, r in enumerate(roots)}
        if not roots:
            raise ValueError("a cluster needs at least one member root")
        self.device = resolve_device(device)
        self.io = io or OsIO()
        self._now = now or time.monotonic
        self.config = config or EngineConfig()
        self.quorum = len(roots) // 2 + 1 if quorum is None else int(quorum)
        self.transport = transport or InProcTransport()
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.segment_bytes = segment_bytes
        self.members: dict[str, ClusterMember] = {}
        self.failovers: list[dict] = []
        self._outstanding: dict[int, dict] = {}
        self._ridmap: dict[tuple[str, int], int] = {}
        self._next_crid = 0
        self._rr = 0

        ids = list(roots)
        self.primary_id = ids[0]
        for nid in ids:
            ep = InProcEndpoint(self.transport, nid)
            self.members[nid] = ClusterMember(
                node_id=nid, root=roots[nid], endpoint=ep, replicator=None,
                engine=None, role="replica", admitted=False)
        pm = self.members[self.primary_id]
        index = open_durable(pm.root, io=self.io, create=create,
                             segment_bytes=segment_bytes,
                             compact_threshold=compact_threshold,
                             device=self.device)
        prim = PrimaryReplicator(
            index, pm.root, pm.endpoint, node_id=pm.node_id,
            quorum=self.quorum, io=self.io, heartbeat_s=heartbeat_s,
            now=self._now, peer_pump=self._pump_replicas)
        prim.attach(segment_bytes)
        pm.replicator = prim
        pm.role = "primary"
        pm.admitted = True
        pm.engine = ServeEngine(index=index, config=self.config,
                                now=self._now, device=self.device)
        for nid in ids[1:]:
            self._start_replica(nid)
            # founding replicas are admitted from the start: routing only
            # considers them once their engine exists (post-bootstrap), so
            # an un-bootstrapped member never sees a query.  Members that
            # RE-join (``restart``) stay unadmitted until caught up.
            self.members[nid].admitted = True

    # ------------------------------------------------------------- membership
    def _start_replica(self, nid: str) -> None:
        m = self.members[nid]
        rep = ReplicaReplicator(
            m.root, m.endpoint, nid, primary_id=self.primary_id, io=self.io,
            now=self._now, segment_bytes=self.segment_bytes,
            heartbeat_timeout_s=self.heartbeat_timeout_s, device=self.device)
        rep.start()
        m.replicator = rep
        m.role = "replica"
        m.engine = None  # built once the index exists (post-bootstrap)
        self._ensure_engine(m)

    def _ensure_engine(self, m: ClusterMember) -> None:
        idx = getattr(m.replicator, "index", None)
        if idx is None:
            return
        if m.engine is None or m.engine.index is not idx:
            # a re-bootstrap replaces the index object; the engine must
            # follow or it would keep serving the discarded one
            m.engine = ServeEngine(index=idx, config=self.config,
                                   now=self._now, device=self.device)

    def _pump_replicas(self) -> None:
        now = self._now()
        for m in self.members.values():
            if isinstance(m.replicator, ReplicaReplicator):
                m.replicator.pump(now)
                self._ensure_engine(m)

    def _live_engines(self) -> list[ClusterMember]:
        return [m for m in self.members.values()
                if m.admitted and m.engine is not None]

    # ---------------------------------------------------------------- routing
    def submit(self, query, rng, k: int | None = None,
               timeout_s: float | None = None):
        """Route one query to an admitted member (round-robin).  Returns a
        `ClusterTicket`, or `Rejected` when every member pushed back —
        backpressure, not an error."""
        crid = self._next_crid
        self._next_crid += 1
        info = {"query": query, "rng": rng, "k": k, "timeout_s": timeout_s,
                "node": None, "rid": None}
        self._outstanding[crid] = info
        if self._route(crid, info):
            return ClusterTicket(crid=crid, node=info["node"])
        del self._outstanding[crid]
        qlen = sum(m.engine.queue_len for m in self._live_engines())
        return Rejected(rid=-1, retry_after=0.05, queue_len=qlen)

    def _route(self, crid: int, info: dict) -> bool:
        targets = self._live_engines()
        if not targets:
            return False
        start = self._rr
        for i in range(len(targets)):
            m = targets[(start + i) % len(targets)]
            res = m.engine.submit(info["query"], info["rng"], k=info["k"],
                                  timeout_s=info["timeout_s"])
            if isinstance(res, Ticket):
                self._rr = (start + i + 1) % len(targets)
                info["node"] = m.node_id
                info["rid"] = res.rid
                self._ridmap[(m.node_id, res.rid)] = crid
                return True
        return False

    def submit_ingest(self, vectors, attrs):
        """Ingest goes to the primary only; the ack that comes back is
        quorum-durable (the `ReplicatedWal` barrier)."""
        m = self.members.get(self.primary_id)
        if m is None or m.role != "primary" or m.engine is None:
            raise RuntimeError("cluster has no live primary for ingest")
        return m.engine.submit_ingest(vectors, attrs)

    def _requeue_dead(self) -> None:
        """Resubmit every outstanding query whose member can no longer
        reply — the 'no query fails' half of failover."""
        for crid, info in list(self._outstanding.items()):
            nid = info["node"]
            if nid is None:
                continue
            m = self.members.get(nid)
            if m is not None and m.engine is not None and m.role != "down":
                continue
            self._ridmap.pop((nid, info["rid"]), None)
            info["node"] = None
            info["rid"] = None

    def _route_orphans(self) -> None:
        for crid, info in self._outstanding.items():
            if info["node"] is None:
                self._route(crid, info)

    # ---------------------------------------------------------------- driving
    def step(self) -> list[ClusterReply]:
        """One cluster turn: pump replication, detect/execute failover,
        re-route orphaned queries, advance every live engine by one
        scheduler step, and collect finished replies."""
        now = self._now()
        pm = self.members.get(self.primary_id)
        if (pm is not None and isinstance(pm.replicator, PrimaryReplicator)
                and not pm.replicator.fenced):
            pm.replicator.pump(now)
        self._pump_replicas()
        self._maybe_failover(now)
        self._route_orphans()
        out: list[ClusterReply] = []
        for m in self.members.values():
            if m.engine is None or m.role == "down":
                continue
            for r in m.engine.step():
                crid = self._ridmap.pop((m.node_id, r.rid), None)
                if crid is None:
                    continue
                self._outstanding.pop(crid, None)
                out.append(ClusterReply(crid=crid, node=m.node_id, reply=r))
        return out

    def drain(self, max_steps: int = 1_000_000) -> list[ClusterReply]:
        """Step until no query is outstanding and every engine is idle."""
        out: list[ClusterReply] = []
        for _ in range(max_steps):
            busy = bool(self._outstanding) or any(
                m.engine is not None and not m.engine.idle
                for m in self.members.values() if m.role != "down")
            if not busy:
                return out
            out.extend(self.step())
        raise RuntimeError(
            f"cluster failed to drain within {max_steps} steps "
            f"({len(self._outstanding)} outstanding)")

    def warmup(self) -> None:
        for m in self.members.values():
            if m.engine is not None:
                m.engine.warmup()

    # --------------------------------------------------------------- failover
    def _candidates(self) -> list[ClusterMember]:
        return [m for m in self.members.values()
                if isinstance(m.replicator, ReplicaReplicator)
                and m.replicator.index is not None and m.role == "replica"]

    def _best_replica(self) -> str | None:
        cands = self._candidates()
        if not cands:
            return None
        cands.sort(key=lambda m: (-m.replicator.durable_lsn, m.node_id))
        return cands[0].node_id

    def _maybe_failover(self, now: float) -> None:
        pm = self.members.get(self.primary_id)
        primary_ok = (pm is not None and pm.role == "primary"
                      and isinstance(pm.replicator, PrimaryReplicator)
                      and not pm.replicator.fenced)
        if primary_ok:
            return
        cands = self._candidates()
        if not cands:
            return
        # heartbeat-timeout trigger: every live replica must agree the
        # primary has gone quiet before anyone is promoted
        if any(c.replicator.primary_alive(now) for c in cands):
            return
        target = self._best_replica()
        epoch = self._promote(self.members[target])
        self.failovers.append(
            {"t": now, "node": target, "epoch": epoch, "planned": False})
        self._requeue_dead()

    def _promote(self, m: ClusterMember) -> int:
        """Promote ``m`` (a bootstrapped replica): epoch strictly above
        everything observed cluster-wide, fence rotated onto disk, then a
        `PrimaryReplicator` takes over its endpoint and every other
        replica re-points."""
        rep = m.replicator
        observed = max((int(getattr(o.replicator, "epoch", 0))
                        for o in self.members.values()
                        if o.replicator is not None), default=0)
        epoch = rep.promote(observed + 1)
        prim = PrimaryReplicator(
            rep.index, m.root, m.endpoint, node_id=m.node_id,
            quorum=self.quorum, io=self.io, heartbeat_s=self.heartbeat_s,
            now=self._now, peer_pump=self._pump_replicas)
        prim.attach(self.segment_bytes)
        old = self.members.get(self.primary_id)
        if old is not None and old is not m and old.role == "primary":
            # planned handover: the deposed primary keeps serving reads
            # until its own restart; its stale epoch fences any append
            old.role = "replica"
        m.replicator = prim
        m.role = "primary"
        m.admitted = True
        self._ensure_engine(m)
        self.primary_id = m.node_id
        for o in self.members.values():
            if o is not m and isinstance(o.replicator, ReplicaReplicator):
                o.replicator.primary_id = m.node_id
                o.replicator._hello()
        return epoch

    # ----------------------------------------------------- restarts / deaths
    def kill(self, nid: str) -> None:
        """Abrupt member death (the in-process stand-in for SIGKILL): no
        checkpoint, no goodbye — its queue vanishes and its outstanding
        queries get resubmitted elsewhere."""
        self._shutdown(nid, checkpoint=False)

    def _shutdown(self, nid: str, checkpoint: bool) -> None:
        m = self.members[nid]
        rep = m.replicator
        idx = getattr(rep, "index", None) if rep is not None else None
        if checkpoint and idx is not None:
            # suppress auto-compaction during the shutdown checkpoint: a
            # replica must never log records of its own (its WAL mirrors
            # the primary's stream record-for-record), and a deposed
            # primary must not ship a stale-epoch append here
            ct = getattr(idx, "compact_threshold", None)
            idx.compact_threshold = None
            try:
                _ckpt.save(idx, m.root, io=self.io)
            finally:
                idx.compact_threshold = ct
        w = getattr(idx, "_wal", None) if idx is not None else None
        if w is None and rep is not None:
            w = getattr(rep, "wal", None)
        if w is not None:
            w.close()
        m.endpoint.close()
        m.replicator = None
        m.engine = None
        m.role = "down"
        m.admitted = False
        self._requeue_dead()

    def restart(self, nid: str) -> None:
        """Bring a down member back as a replica: reopen its durable root
        (or resume/request a bootstrap), rejoin, start catching up.  Not
        admitted for queries until ``_await_caught_up``/the caller says
        so."""
        m = self.members[nid]
        if m.role != "down":
            raise RuntimeError(f"{nid} is not down (role={m.role})")
        m.endpoint = InProcEndpoint(self.transport, nid)
        self._start_replica(nid)
        m.admitted = False

    def _await_caught_up(self, nid: str,
                         max_steps: int = 100_000) -> list[ClusterReply]:
        out: list[ClusterReply] = []
        m = self.members[nid]
        for _ in range(max_steps):
            rep = m.replicator
            if isinstance(rep, ReplicaReplicator) and rep.caught_up():
                return out
            out.extend(self.step())
        raise RuntimeError(f"{nid} failed to catch up within "
                           f"{max_steps} steps")

    def _drain_member(self, nid: str,
                      max_steps: int = 100_000) -> list[ClusterReply]:
        out: list[ClusterReply] = []
        m = self.members[nid]
        for _ in range(max_steps):
            if m.engine is None or m.engine.idle:
                return out
            out.extend(self.step())
        raise RuntimeError(f"{nid} failed to drain within {max_steps} steps")

    def rolling_restart(self) -> dict:
        """Zero-downtime restart of every member, one at a time: drain ->
        checkpoint -> shutdown -> restart as replica -> catch up ->
        readmit.  The primary goes last behind a planned handover (drain,
        promote the most-durable replica, rejoin as a replica).  Replies
        produced along the way are returned — queries keep completing
        throughout."""
        replies: list[ClusterReply] = []
        events: list[tuple[str, str]] = []
        order = [nid for nid in self.members if nid != self.primary_id]
        order.append(self.primary_id)
        for nid in order:
            m = self.members[nid]
            if nid == self.primary_id:
                replies.extend(self._drain_member(nid))
                target = self._best_replica()
                if target is None:
                    raise RuntimeError("no replica to hand the primary "
                                       "role to")
                epoch = self._promote(self.members[target])
                self.failovers.append({"t": self._now(), "node": target,
                                       "epoch": epoch, "planned": True})
                events.append(("handover", target))
            m.admitted = False
            replies.extend(self._drain_member(nid))
            self._shutdown(nid, checkpoint=True)
            self.restart(nid)
            replies.extend(self._await_caught_up(nid))
            m.admitted = True
            events.append(("restarted", nid))
        return {"events": events, "replies": replies}

    # ----------------------------------------------------------------- state
    def status(self) -> dict:
        return {
            "primary": self.primary_id,
            "quorum": self.quorum,
            "failovers": list(self.failovers),
            "members": {
                nid: {
                    "role": m.role,
                    "admitted": m.admitted,
                    "replication": (m.replicator.status()
                                    if m.replicator is not None else None),
                    "engine": (m.engine.engine_stats()
                               if m.engine is not None else None),
                }
                for nid, m in self.members.items()
            },
        }
