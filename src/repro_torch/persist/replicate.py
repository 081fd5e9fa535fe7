"""Primary -> replica replication: WAL shipping, quorum acks, epoch fencing
(the port of ``repro.persist.replicate``: the same frames, message kinds
and bootstrap files, so a primary of either package feeds a replica of the
other).

The unit of replication is the existing self-checksummed WAL record: the
primary appends to its own log (`ReplicatedWal`, a `WalWriter`) and ships
every record to its replicas over an injectable transport; the log's
group-commit barrier (``append(fsync=False)`` ... ``sync()``) *is* the
quorum barrier — ``sync()`` returns only after the local fsync AND the
configured quorum of replicas have fsynced the records, so the serve
engine's ingest ack (which already sits behind ``wal.sync()``) becomes a
quorum-durable ack with no engine changes.

A replica (`ReplicaReplicator`) appends each record to its own WAL at the
same LSN, fsyncs, applies it under the ``_wal_replaying`` guard (no
re-log, no auto-compaction — the same replay discipline recovery uses),
and sends a cumulative ACK.  Out-of-order arrivals buffer; gaps NACK the
expected LSN and the primary re-ships.  Two indices that acked the same
LSN are bitwise-equal (``state_digest``) by the WAL's replay contract.
The replica's ``device`` (None = the CUDA card) is its index's build
device: a shipped ``"device"`` insert record is applied through the
device build there, whose searches launch the ``gather_norm_dot`` kernel.

Bootstrap: a fresh replica streams the primary's newest *full* checkpoint
chunk-by-chunk (per-chunk CRC32 from the manifest section table), then
catches up from the WAL suffix.  A dropped chunk or a replica crash
mid-bootstrap resumes by re-requesting only the chunks whose bytes on
disk fail their CRC — never the full copy.

Fencing: every WAL segment header and checkpoint manifest carries an
epoch/term.  Promotion bumps the epoch and rotates, so the fence is on
disk before any new-term record; a replica refuses appends whose epoch is
*strictly* below its own (replying FENCED), and a fenced primary's
``ReplicatedWal`` raises `StaleEpochError` instead of acking.  Epoch
comparisons are strict (``<``/``>``) by contract.

Transports: `InProcTransport` (deterministic in-process queues, the test
harness default), `SocketEndpoint` (localhost TCP for cross-process
failover tests), and `FaultTransport` (a faultfs-style deterministic
fault schedule — drop / duplicate / delay-reorder / partition keyed by
per-link message sequence number) wrapping either.  Payloads are the
WAL's numpy bytes: no tensor ever reaches a message.
"""
from __future__ import annotations

import json
import os
import select
import socket
import struct
import time
from collections import OrderedDict, deque

from .. import resolve_device
from . import checkpoint as _ckpt
from . import recovery as _recovery
from .faultfs import OsIO
from .format import (
    MANIFEST_NAME,
    STREAM_CHUNK_BYTES,
    CorruptError,
    canonical_json,
    chunk_crcs,
    crc32,
    read_manifest,
)
from .wal import StaleEpochError, WalCorruptError, WalWriter, apply_record
from .wal import read_log as _read_log

# ------------------------------------------------------------- message codec
MSG_HELLO = 1
MSG_APPEND = 2
MSG_ACK = 3
MSG_NACK = 4
MSG_HEARTBEAT = 5
MSG_FENCED = 6
MSG_BOOT_REQ = 7
MSG_CKPT_META = 8
MSG_CKPT_CHUNK = 9
MSG_CKPT_DONE = 10

BOOT_PART_NAME = "MANIFEST.part"


class QuorumTimeoutError(RuntimeError):
    """The configured quorum did not fsync within the pump budget — the
    write is NOT acked (it may still be locally durable); the caller
    treats this as backpressure/unavailability, never as success."""


def encode_msg(kind: int, head: dict, payload: bytes = b"") -> bytes:
    """One replication message: u32 crc | u8 kind | u32 jlen | canonical
    JSON head | raw payload.  The CRC covers everything after it, so a
    corrupt frame is dropped at decode (retransmission heals it)."""
    hj = canonical_json(head)
    body = struct.pack("<BI", kind, len(hj)) + hj + payload
    return struct.pack("<I", crc32(body)) + body


def decode_msg(data: bytes) -> tuple[int, dict, bytes]:
    if len(data) < 9:
        raise CorruptError("replication frame too short")
    (stated,) = struct.unpack_from("<I", data)
    body = data[4:]
    if crc32(body) != stated:
        raise CorruptError("replication frame CRC mismatch")
    kind, jlen = struct.unpack_from("<BI", body)
    head = json.loads(body[5:5 + jlen])
    return kind, head, body[5 + jlen:]


# ---------------------------------------------------------------- transports
class InProcTransport:
    """Ordered, lossless in-process message queues keyed by node id — the
    deterministic base layer the fault schedule wraps.  ``kill()`` models
    process death: the node's queue vanishes and sends to it fail."""

    def __init__(self):
        self._queues: dict[str, deque] = {}

    def register(self, node_id: str) -> None:
        self._queues.setdefault(node_id, deque())

    def kill(self, node_id: str) -> None:
        self._queues.pop(node_id, None)

    def alive(self, node_id: str) -> bool:
        return node_id in self._queues

    def send(self, src: str, dst: str, data: bytes) -> bool:
        q = self._queues.get(dst)
        if q is None:
            return False
        q.append((src, data))
        return True

    def poll(self, node_id: str) -> list[tuple[str, bytes]]:
        q = self._queues.get(node_id)
        if not q:
            return []
        out = list(q)
        q.clear()
        return out


class FaultSchedule:
    """Deterministic per-link fault plan keyed by the link's message
    sequence number (1-based, counted per (src, dst) direction):

    * ``drop``       — iterable of (src, dst, seq): message vanishes
    * ``dup``        — iterable of (src, dst, seq): delivered twice
    * ``delay``      — iterable of (src, dst, seq, hold): held back until
      ``hold`` further messages pass on the link (reordering)
    * ``partitions`` — iterable of (src, dst, lo, hi): every message with
      ``lo <= seq <= hi`` on the link is dropped (a one-way partition;
      list both directions for a full one)
    """

    def __init__(self, drop=(), dup=(), delay=(), partitions=()):
        self.drop = {(s, d, q) for s, d, q in drop}
        self.dup = {(s, d, q) for s, d, q in dup}
        self.delay = {(s, d, q): hold for s, d, q, hold in delay}
        self.partitions = list(partitions)

    def is_dropped(self, src: str, dst: str, seq: int) -> bool:
        if (src, dst, seq) in self.drop:
            return True
        return any(s == src and d == dst and lo <= seq <= hi
                   for s, d, lo, hi in self.partitions)

    def is_dup(self, src: str, dst: str, seq: int) -> bool:
        return (src, dst, seq) in self.dup

    def delay_of(self, src: str, dst: str, seq: int) -> int:
        return self.delay.get((src, dst, seq), 0)


class FaultTransport:
    """Wraps an `InProcTransport`-shaped transport with a `FaultSchedule`.
    Dropped messages still report success to the sender (network loss is
    silent); counters expose what was injected so tests can assert the
    schedule actually fired."""

    def __init__(self, inner: InProcTransport, schedule: FaultSchedule):
        self.inner = inner
        self.schedule = schedule
        self._seq: dict[tuple[str, str], int] = {}
        self._held: dict[tuple[str, str], list] = {}
        self.dropped = 0
        self.duplicated = 0
        self.delayed = 0

    def register(self, node_id: str) -> None:
        self.inner.register(node_id)

    def kill(self, node_id: str) -> None:
        self.inner.kill(node_id)

    def alive(self, node_id: str) -> bool:
        return self.inner.alive(node_id)

    def send(self, src: str, dst: str, data: bytes) -> bool:
        link = (src, dst)
        seq = self._seq.get(link, 0) + 1
        self._seq[link] = seq
        sched = self.schedule
        ok = True
        if sched.is_dropped(src, dst, seq):
            self.dropped += 1
        elif sched.delay_of(src, dst, seq):
            self._held.setdefault(link, []).append(
                (seq + sched.delay_of(src, dst, seq), data))
            self.delayed += 1
        else:
            ok = self.inner.send(src, dst, data)
            if sched.is_dup(src, dst, seq):
                self.inner.send(src, dst, data)
                self.duplicated += 1
        held = self._held.get(link)
        if held:
            keep = []
            for release, msg in held:
                if release <= seq:
                    self.inner.send(src, dst, msg)
                else:
                    keep.append((release, msg))
            self._held[link] = keep
        return ok

    def heal(self) -> None:
        """Deliver every still-held (delayed) message now."""
        for (src, dst), held in self._held.items():
            for _release, msg in held:
                self.inner.send(src, dst, msg)
            held.clear()

    def poll(self, node_id: str) -> list[tuple[str, bytes]]:
        return self.inner.poll(node_id)


class InProcEndpoint:
    """Per-node view over an (optionally fault-wrapped) transport — the
    interface the replicators speak: ``send(dst, data)``, ``poll()``,
    ``connect(peer, head=...)``."""

    def __init__(self, transport, node_id: str):
        self.transport = transport
        self.node_id = node_id
        transport.register(node_id)

    def connect(self, peer_id: str, addr=None, head: dict | None = None):
        h = {"node": self.node_id}
        h.update(head or {})
        self.send(peer_id, encode_msg(MSG_HELLO, h))

    def send(self, dst: str, data: bytes) -> bool:
        return self.transport.send(self.node_id, dst, data)

    def poll(self) -> list[tuple[str, bytes]]:
        return self.transport.poll(self.node_id)

    def close(self) -> None:
        self.transport.kill(self.node_id)


class SocketEndpoint:
    """Localhost-TCP endpoint with the same surface as `InProcEndpoint`.
    Frames are u32-length-prefixed; the first frame on an inbound
    connection must be a HELLO naming the peer (it is also delivered to
    the application, which uses it to register the peer).  Used by the
    cross-process SIGKILL failover test, where the primary genuinely dies
    mid-ingest."""

    RECV_BYTES = 1 << 16

    def __init__(self, node_id: str, host: str = "127.0.0.1", port: int = 0):
        self.node_id = node_id
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self._listener.setblocking(False)
        self._conns: dict[str, socket.socket] = {}
        self._bufs: dict[socket.socket, bytearray] = {}
        self._unnamed: list[socket.socket] = []

    @property
    def addr(self) -> tuple[str, int]:
        return self._listener.getsockname()

    def connect(self, peer_id: str, addr, head: dict | None = None) -> None:
        s = socket.create_connection(addr, timeout=10.0)
        s.settimeout(10.0)
        self._conns[peer_id] = s
        self._bufs[s] = bytearray()
        h = {"node": self.node_id}
        h.update(head or {})
        self._send_frame(s, encode_msg(MSG_HELLO, h))

    def _send_frame(self, s: socket.socket, data: bytes) -> None:
        s.sendall(struct.pack("<I", len(data)) + data)

    def send(self, dst: str, data: bytes) -> bool:
        s = self._conns.get(dst)
        if s is None:
            return False
        try:
            self._send_frame(s, data)
            return True
        except OSError:
            self._drop(dst)
            return False

    def _drop(self, peer_id: str) -> None:
        s = self._conns.pop(peer_id, None)
        if s is not None:
            self._bufs.pop(s, None)
            try:
                s.close()
            except OSError:
                pass

    def _readable(self, s) -> bool:
        r, _, _ = select.select([s], [], [], 0)
        return bool(r)

    def poll(self) -> list[tuple[str, bytes]]:
        while self._readable(self._listener):
            try:
                c, _ = self._listener.accept()
            except OSError:
                break
            c.settimeout(10.0)
            self._unnamed.append(c)
            self._bufs[c] = bytearray()
        out: list[tuple[str, bytes]] = []
        for peer, s in (list(self._conns.items())
                        + [(None, c) for c in list(self._unnamed)]):
            dead = False
            while self._readable(s):
                try:
                    data = s.recv(self.RECV_BYTES)
                except OSError:
                    data = b""
                if not data:
                    dead = True
                    break
                self._bufs[s] += data
            buf = self._bufs.get(s)
            while buf is not None and len(buf) >= 4:
                (ln,) = struct.unpack_from("<I", buf)
                if len(buf) < 4 + ln:
                    break
                frame = bytes(buf[4:4 + ln])
                del buf[:4 + ln]
                if peer is None:
                    # first frame names the connection
                    try:
                        kind, head, _ = decode_msg(frame)
                    except CorruptError:
                        dead = True
                        break
                    if kind != MSG_HELLO:
                        dead = True
                        break
                    peer = head["node"]
                    self._unnamed.remove(s)
                    self._conns[peer] = s
                out.append((peer, frame))
            if dead:
                if peer is not None:
                    self._drop(peer)
                elif s in self._unnamed:
                    self._unnamed.remove(s)
                    self._bufs.pop(s, None)
                    try:
                        s.close()
                    except OSError:
                        pass
        return out

    def peers(self) -> list[str]:
        return list(self._conns)

    def close(self) -> None:
        for peer in list(self._conns):
            self._drop(peer)
        try:
            self._listener.close()
        except OSError:
            pass


# ----------------------------------------------------------------- primary
class _Peer:
    __slots__ = ("node_id", "durable_lsn", "sent_upto", "last_seen")

    def __init__(self, node_id: str, lsn: int = 0):
        self.node_id = node_id
        self.durable_lsn = lsn
        self.sent_upto = lsn
        self.last_seen = 0.0


class ReplicatedWal(WalWriter):
    """A `WalWriter` whose records also ship to replicas and whose
    ``sync()`` is the *quorum* group-commit barrier: local fsync first,
    then block until the configured quorum of members (this primary
    included) has fsynced through the last appended LSN.  Because the
    serve engine's ingest ack already sits behind ``wal.sync()``, swapping
    this writer in makes every ack quorum-durable with no engine change."""

    def __init__(self, dirpath: str, primary: "PrimaryReplicator",
                 io: OsIO | None = None, segment_bytes: int = 4 << 20,
                 epoch: int | None = None):
        super().__init__(dirpath, io=io, segment_bytes=segment_bytes,
                         epoch=epoch)
        self._primary = primary

    def append(self, rtype: int, payload: bytes = b"",
               fsync: bool = True) -> int:
        self._primary.check_fenced()
        lsn = super().append(rtype, payload, fsync=False)
        self._primary.ship(rtype, lsn, payload)
        if fsync:
            self.sync()
        return lsn

    def sync(self) -> None:
        super().sync()
        self._primary.await_quorum(self.next_lsn - 1)


class PrimaryReplicator:
    """The primary's half of the protocol: per-peer shipping state, the
    quorum wait, heartbeats, catch-up/retransmission, and chunked
    checkpoint streaming for bootstrapping replicas.

    ``quorum`` counts the primary itself: 1 = local durability only
    (replicas are asynchronous), 2 = at least one replica must fsync
    before an ack, etc.  ``peer_pump`` is an optional callable invoked
    once per pump — the in-process cluster points it at the replicas'
    ``pump()`` so a quorum wait makes progress inside one process."""

    def __init__(self, index, root: str, endpoint, node_id: str = "primary",
                 quorum: int = 1, io: OsIO | None = None,
                 heartbeat_s: float = 0.05, now=None, idle_s: float = 0.0,
                 max_pumps: int = 200_000, stall_pumps: int = 64,
                 tail_cap: int = 1024, peer_pump=None):
        self.index = index
        self.root = root
        self.endpoint = endpoint
        self.node_id = node_id
        self.quorum = int(quorum)
        self.io = io or OsIO()
        self.heartbeat_s = heartbeat_s
        self.idle_s = idle_s
        self.max_pumps = max_pumps
        self.stall_pumps = stall_pumps
        self.tail_cap = tail_cap
        self.peer_pump = peer_pump
        self._now = now or time.monotonic
        self.epoch = int(getattr(index, "_epoch", 0))
        self.fenced = False
        self.peers: dict[str, _Peer] = {}
        self._tail: OrderedDict[int, tuple[int, bytes]] = OrderedDict()
        self._last_lsn = int(getattr(index, "_applied_lsn", 0))
        # the LSN at which this primary's epoch began: records at or below
        # it are shared history (every replica's log is a prefix of the
        # promoted max-durable log), records above it belong to this term.
        # A HELLO from a *lower* epoch claiming an LSN above this base may
        # be a deposed primary's diverged unacked suffix.
        self.epoch_base = self._last_lsn
        self._last_hb = float("-inf")
        self._awaiting = False

    # ------------------------------------------------------------ lifecycle
    def attach(self, segment_bytes: int = 4 << 20) -> ReplicatedWal:
        """Replace the index's plain `WalWriter` with a `ReplicatedWal`
        over the same log directory.  Call after ``open_durable``."""
        old = getattr(self.index, "_wal", None)
        if old is not None:
            old.close()
        rw = ReplicatedWal(_recovery.wal_dir(self.root), self, io=self.io,
                           segment_bytes=segment_bytes, epoch=self.epoch)
        self.index._wal = rw
        self._last_lsn = rw.next_lsn - 1
        self.epoch_base = self._last_lsn  # no new-term records appended yet
        return rw

    def check_fenced(self) -> None:
        if self.fenced:
            raise StaleEpochError(
                f"primary {self.node_id} (epoch {self.epoch}) is fenced by "
                f"a newer epoch: refusing to append"
            )

    def _fence(self, newer_epoch: int) -> None:
        if newer_epoch > self.epoch:
            self.fenced = True

    # ------------------------------------------------------------- shipping
    def ship(self, rtype: int, lsn: int, payload: bytes) -> None:
        """Ship one just-appended record to every caught-up peer (lagging
        peers are served by ``_catch_up`` so their stream stays ordered)."""
        self.check_fenced()
        self._last_lsn = lsn
        self._tail[lsn] = (rtype, payload)
        while len(self._tail) > self.tail_cap:
            self._tail.popitem(last=False)
        msg = encode_msg(MSG_APPEND, {
            "epoch": self.epoch, "lsn": lsn, "rtype": rtype,
            "commit": lsn,
        }, payload)
        for p in self.peers.values():
            if p.sent_upto == lsn - 1 and self.endpoint.send(p.node_id, msg):
                p.sent_upto = lsn

    def acked_count(self, lsn: int) -> int:
        """Members (primary included) known to have fsynced through
        ``lsn``."""
        return 1 + sum(1 for p in self.peers.values()
                       if p.durable_lsn >= lsn)

    def await_quorum(self, lsn: int) -> None:
        """Block (pumping the transport) until ``quorum`` members have
        fsynced through ``lsn``.  The local fsync already happened
        (`ReplicatedWal.sync` runs it first), so the ack that follows this
        barrier is quorum-durable.  Raises `QuorumTimeoutError` after the
        pump budget — a refusal, never a false ack."""
        self.check_fenced()
        if self.quorum <= 1 or lsn <= 0 or self._awaiting:
            # re-entrant waits (an auto-compaction record logged while
            # serving a bootstrap inside an outer wait) collapse into the
            # outer barrier, which always waits for the highest ack
            return
        self._awaiting = True
        try:
            pumps = 0
            while self.acked_count(lsn) < self.quorum:
                progressed = self.pump()
                self.check_fenced()
                pumps += 1
                if not progressed and pumps % self.stall_pumps == 0:
                    self._retransmit(lsn)
                if pumps > self.max_pumps:
                    raise QuorumTimeoutError(
                        f"quorum {self.quorum} not reached for LSN {lsn} "
                        f"({self.acked_count(lsn)} acked) within "
                        f"{self.max_pumps} pumps"
                    )
        finally:
            self._awaiting = False

    def _retransmit(self, lsn: int) -> None:
        for p in self.peers.values():
            if p.durable_lsn < lsn:
                p.sent_upto = p.durable_lsn
                self._catch_up(p)

    # ------------------------------------------------------------- pumping
    def pump(self, now: float | None = None) -> bool:
        """Deliver inbound messages and heartbeat on cadence.  Returns
        True when at least one message was processed."""
        if self.peer_pump is not None:
            self.peer_pump()
        now = self._now() if now is None else now
        msgs = self.endpoint.poll()
        for src, data in msgs:
            self._on_msg(src, data, now)
        self.maybe_heartbeat(now)
        if not msgs and self.idle_s:
            time.sleep(self.idle_s)
        return bool(msgs)

    def maybe_heartbeat(self, now: float) -> None:
        if now - self._last_hb < self.heartbeat_s:
            return
        self._last_hb = now
        msg = encode_msg(MSG_HEARTBEAT,
                         {"epoch": self.epoch, "lsn": self._last_lsn})
        for p in self.peers.values():
            self.endpoint.send(p.node_id, msg)

    def _peer(self, node_id: str) -> _Peer:
        p = self.peers.get(node_id)
        if p is None:
            p = self.peers[node_id] = _Peer(node_id)
        return p

    def _on_msg(self, src: str, data: bytes, now: float) -> None:
        try:
            kind, head, payload = decode_msg(data)
        except CorruptError:
            return  # corrupt frame: drop; retransmission heals
        if kind == MSG_HELLO:
            p = self._peer(src)
            p.last_seen = now
            p.durable_lsn = int(head.get("lsn", 0))
            p.sent_upto = p.durable_lsn
            hello_epoch = int(head.get("epoch", 0))
            if hello_epoch > self.epoch:
                self._fence(hello_epoch)
                return
            diverged = p.durable_lsn > self._last_lsn or (
                hello_epoch < self.epoch
                and p.durable_lsn > self.epoch_base
            )
            # answer every HELLO with an immediate heartbeat so the peer
            # learns the commit LSN (and that we are alive) even when it
            # is already caught up and no record will be shipped
            self.endpoint.send(src, encode_msg(
                MSG_HEARTBEAT, {"epoch": self.epoch, "lsn": self._last_lsn}))
            if head.get("boot"):
                self._serve_bootstrap(src, head)
            elif diverged:
                # a peer with records past our tail, or from an older term
                # with records past our promotion point, may hold a
                # diverged unacked suffix — e.g. the deposed primary
                # rejoining.  Reconciliation is a full re-bootstrap: it
                # discards its local state and streams ours (the simple,
                # always-safe Raft-truncation analogue).  A lower-epoch
                # peer at or below the base is just lagging shared history
                # and catches up normally.
                self._serve_bootstrap(src, {"have": {}})
            else:
                self._catch_up(p)
        elif kind == MSG_ACK:
            ack_epoch = int(head["epoch"])
            if ack_epoch > self.epoch:
                self._fence(ack_epoch)
                return
            if ack_epoch < self.epoch:
                return  # stale-term ack: ignore
            p = self._peer(src)
            p.last_seen = now
            if head["lsn"] > p.durable_lsn:
                p.durable_lsn = int(head["lsn"])
            if p.sent_upto < p.durable_lsn:
                p.sent_upto = p.durable_lsn
            self._catch_up(p)
        elif kind == MSG_NACK:
            p = self._peer(src)
            p.last_seen = now
            p.sent_upto = max(int(head["expect"]) - 1, 0)
            self._catch_up(p)
        elif kind == MSG_FENCED:
            self._fence(int(head["epoch"]))
        elif kind == MSG_BOOT_REQ:
            self._peer(src).last_seen = now
            self._serve_bootstrap(src, head)

    # ------------------------------------------------- catch-up / bootstrap
    def _records_from(self, lsn: int):
        """Records >= ``lsn`` from the in-memory tail or the on-disk log;
        None when the log no longer reaches back that far (pruned) and the
        peer must bootstrap from a checkpoint instead."""
        if self._tail and lsn >= next(iter(self._tail)):
            return [(l, t, p) for l, (t, p) in self._tail.items()
                    if l >= lsn]
        recs = [(l, t, p)
                for l, t, p in _read_log(_recovery.wal_dir(self.root),
                                         io=self.io, truncate_torn=False)
                if l >= lsn]
        if recs and recs[0][0] != lsn:
            return None
        if not recs and lsn <= self._last_lsn:
            return None
        return recs

    def _catch_up(self, peer: _Peer) -> None:
        if peer.sent_upto > peer.durable_lsn:
            return  # records in flight; a NACK or stall will reset
        if peer.durable_lsn >= self._last_lsn:
            return
        recs = self._records_from(peer.durable_lsn + 1)
        if recs is None:
            self._serve_bootstrap(peer.node_id, {"have": {}})
            return
        for lsn, rtype, payload in recs:
            msg = encode_msg(MSG_APPEND, {
                "epoch": self.epoch, "lsn": lsn, "rtype": rtype,
                "commit": self._last_lsn,
            }, payload)
            if not self.endpoint.send(peer.node_id, msg):
                return
            peer.sent_upto = lsn

    def _serve_bootstrap(self, dst: str, head: dict) -> None:
        """Stream the newest FULL checkpoint to ``dst``: manifest, then
        every chunk the peer does not already hold (``head['have']`` maps
        section name -> chunk indices that validated on its disk — the
        resume path), then DONE, then the WAL suffix past the checkpoint."""
        # whatever the peer claimed to hold is void once it re-bootstraps
        # (its history may diverge) — it must not count toward any quorum
        # until it acks records from *this* stream
        p = self._peer(dst)
        p.durable_lsn = 0
        p.sent_upto = 0
        ckpts = _ckpt.list_checkpoints(self.root)
        man = None
        if ckpts:
            try:
                man = read_manifest(ckpts[-1][1])
            except CorruptError:
                man = None
        if man is None or man["kind"] != "full":
            _ckpt.save(self.index, self.root, io=self.io, incremental=False)
            ckpts = _ckpt.list_checkpoints(self.root)
            man = read_manifest(ckpts[-1][1])
        path = dict(ckpts)[man["seq"]]
        have = head.get("have") or {}
        self.endpoint.send(dst, encode_msg(
            MSG_CKPT_META, {"manifest": man, "epoch": self.epoch}))
        for name in sorted(man["sections"]):
            entry = man["sections"][name]
            with open(os.path.join(path, entry["file"]), "rb") as f:
                data = f.read()
            cb = int(entry.get("chunk_bytes", STREAM_CHUNK_BYTES))
            crcs = entry.get("chunk_crcs") or chunk_crcs(data, cb)
            got = set(have.get(name, ()))
            for ci, c in enumerate(crcs):
                if ci in got:
                    continue
                off = ci * cb
                ok = self.endpoint.send(dst, encode_msg(
                    MSG_CKPT_CHUNK,
                    {"section": name, "ci": ci, "off": off, "crc": c},
                    data[off:off + cb]))
                if not ok:
                    return
        self.endpoint.send(dst, encode_msg(MSG_CKPT_DONE, {
            "seq": man["seq"], "lsn": man["meta"]["lsn"],
            "epoch": self.epoch,
        }))
        p = self._peer(dst)
        lsn = int(man["meta"]["lsn"])
        p.sent_upto = max(p.sent_upto, lsn)
        recs = self._records_from(lsn + 1) or []
        for rlsn, rtype, payload in recs:
            msg = encode_msg(MSG_APPEND, {
                "epoch": self.epoch, "lsn": rlsn, "rtype": rtype,
                "commit": self._last_lsn,
            }, payload)
            if not self.endpoint.send(dst, msg):
                return
            p.sent_upto = rlsn

    # ---------------------------------------------------------------- state
    def status(self) -> dict:
        return {
            "node": self.node_id,
            "role": "primary",
            "epoch": self.epoch,
            "fenced": self.fenced,
            "lsn": self._last_lsn,
            "quorum": self.quorum,
            "peers": {
                p.node_id: {"durable_lsn": p.durable_lsn,
                            "lag": max(0, self._last_lsn - p.durable_lsn)}
                for p in self.peers.values()
            },
        }


# ----------------------------------------------------------------- replica
class ReplicaReplicator:
    """The replica's half: append each shipped record to its own WAL at
    the same LSN, fsync, apply under ``_wal_replaying``, cumulative-ACK.
    Buffers out-of-order arrivals, NACKs gaps, refuses stale epochs
    (strictly — ``epoch < self.epoch`` is fenced, ``>`` adopts), and
    bootstraps by streaming the primary's checkpoint with chunk-level
    resume.  ``device`` (None = the CUDA card; raises without CUDA) is the
    build device of the replica's index, whether recovered from its own
    root or materialized from a streamed checkpoint."""

    def __init__(self, root: str, endpoint, node_id: str,
                 primary_id: str | None = None, io: OsIO | None = None,
                 now=None, segment_bytes: int = 4 << 20,
                 heartbeat_timeout_s: float = 0.5, nack_every: int = 8,
                 oo_cap: int = 256, device=None):
        self.root = root
        self.device = resolve_device(device)
        self.endpoint = endpoint
        self.node_id = node_id
        self.primary_id = primary_id
        self.io = io or OsIO()
        self._now = now or time.monotonic
        self.segment_bytes = segment_bytes
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.nack_every = nack_every
        self.oo_cap = oo_cap
        self.index = None
        self.wal: WalWriter | None = None
        self.epoch = 0
        self.primary_lsn = 0  # newest commit LSN heard from the primary
        self.last_heard: float | None = None
        self._oo: dict[int, tuple[int, bytes]] = {}
        self._boot: dict | None = None
        self._msgs_since_nack = 0
        self._hello_t = float("-inf")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Open local durable state if present (recover + attach WAL),
        else request a streamed bootstrap.  A half-finished bootstrap on
        disk resumes: only chunks whose bytes fail their CRC re-ship."""
        if _recovery.is_durable_dir(self.root):
            self.index = _recovery.open_durable(
                self.root, io=self.io, segment_bytes=self.segment_bytes,
                device=self.device)
            self.wal = self.index._wal
            self.epoch = int(self.index._epoch)
            self._hello()
            return
        resumed = self._resume_boot_from_disk()
        if self.primary_id is not None:
            if resumed:
                self._request_boot()
            else:
                self._hello(boot=True)

    def _hello(self, boot: bool = False) -> None:
        if self.primary_id is None:
            return
        head = {"node": self.node_id, "lsn": self.durable_lsn,
                "epoch": self.epoch}
        if boot:
            head["boot"] = True
        self._hello_t = self._now()
        self.endpoint.send(self.primary_id, encode_msg(MSG_HELLO, head))

    @property
    def durable_lsn(self) -> int:
        """Highest LSN in the local log (== fsynced-through at every ack
        boundary: `_drain` syncs before acking)."""
        if self.wal is not None:
            return self.wal.next_lsn - 1
        return 0

    def lag(self) -> int:
        """How far the local durable LSN trails the primary's commit."""
        return max(0, self.primary_lsn - self.durable_lsn)

    def caught_up(self) -> bool:
        # requires at least one contact: before the first heartbeat the
        # primary's commit LSN is unknown and lag() would read as zero
        return (self.index is not None and self.last_heard is not None
                and self.lag() == 0)

    def primary_alive(self, now: float | None = None) -> bool:
        """False once the heartbeat timeout elapsed with no traffic from
        the primary — the cluster's failover trigger."""
        if self.last_heard is None:
            return True  # never heard: grace until first contact
        now = self._now() if now is None else now
        return (now - self.last_heard) < self.heartbeat_timeout_s

    # -------------------------------------------------------------- pumping
    def pump(self, now: float | None = None) -> int:
        now = self._now() if now is None else now
        msgs = self.endpoint.poll()
        for src, data in msgs:
            try:
                kind, head, payload = decode_msg(data)
            except CorruptError:
                continue  # corrupt frame: drop; retransmission heals
            self._on_msg(src, kind, head, payload, now)
        if (self.last_heard is None and self.primary_id is not None
                and now - self._hello_t >= self.heartbeat_timeout_s):
            # the initial HELLO may have been lost on the wire — retry on
            # the heartbeat-timeout cadence until the primary answers
            if self._boot is not None:
                self._hello_t = now
                self._request_boot()
            else:
                self._hello(boot=self.index is None)
        return len(msgs)

    def _on_msg(self, src: str, kind: int, head: dict, payload: bytes,
                now: float) -> None:
        if kind == MSG_HELLO:
            self.primary_id = src
            self.last_heard = now
            if self.index is not None:
                self._hello()
            elif self._boot is None:
                self._hello(boot=True)
            else:
                self._request_boot()
        elif kind == MSG_APPEND:
            self._on_append(src, head, payload, now)
        elif kind == MSG_HEARTBEAT:
            self._on_heartbeat(src, head, now)
        elif kind == MSG_CKPT_META:
            self.last_heard = now
            self._on_ckpt_meta(head)
        elif kind == MSG_CKPT_CHUNK:
            self.last_heard = now
            self._on_ckpt_chunk(head, payload)
        elif kind == MSG_CKPT_DONE:
            self.last_heard = now
            self._on_ckpt_done(src, head)

    def _check_epoch(self, src: str, msg_epoch: int) -> bool:
        """Strict fencing: a lower epoch is refused (FENCED reply), a
        higher one adopted (the sender is a newer primary)."""
        if msg_epoch < self.epoch:
            self.endpoint.send(src, encode_msg(
                MSG_FENCED, {"epoch": self.epoch}))
            return False
        if msg_epoch > self.epoch:
            self._adopt_epoch(msg_epoch)
        return True

    def _adopt_epoch(self, msg_epoch: int) -> None:
        self.epoch = msg_epoch
        if self.wal is not None:
            self.wal.set_epoch(msg_epoch)
        if self.index is not None:
            self.index._epoch = msg_epoch

    def _on_append(self, src: str, head: dict, payload: bytes,
                   now: float) -> None:
        if not self._check_epoch(src, int(head["epoch"])):
            return
        self.primary_id = src
        self.last_heard = now
        self.primary_lsn = max(self.primary_lsn, int(head.get("commit", 0)),
                               int(head["lsn"]))
        if self.index is None or self.wal is None:
            return  # bootstrapping: the suffix re-ships after finalize
        lsn = int(head["lsn"])
        if lsn <= self.durable_lsn:
            self._send_ack(src)  # duplicate: idempotent cumulative re-ack
            return
        if lsn == self.durable_lsn + 1 or len(self._oo) < self.oo_cap:
            self._oo[lsn] = (int(head["rtype"]), payload)
        self._drain(src)
        if self.durable_lsn + 1 not in self._oo and lsn > self.durable_lsn + 1:
            self._maybe_nack(src)

    def _drain(self, src: str) -> None:
        """Append every consecutive buffered record (one group-commit
        fsync), apply them under the replay guard, then cumulative-ACK —
        log -> fsync -> apply -> ack, the same discipline as recovery."""
        staged: list[tuple[int, int, bytes]] = []
        nxt = self.durable_lsn + 1
        while nxt in self._oo:
            rtype, payload = self._oo.pop(nxt)
            got = self.wal.append(rtype, payload, fsync=False)
            if got != nxt:
                raise WalCorruptError(
                    f"replica log continuity broken: appended at {got}, "
                    f"expected {nxt}"
                )
            staged.append((nxt, rtype, payload))
            nxt += 1
        if staged:
            self.wal.sync()
            idx = self.index
            idx._wal_replaying = True
            try:
                for lsn, rtype, payload in staged:
                    apply_record(idx, rtype, payload)
                    idx._applied_lsn = lsn
            finally:
                idx._wal_replaying = False
            self._send_ack(src)

    def _send_ack(self, dst: str) -> None:
        self.endpoint.send(dst, encode_msg(
            MSG_ACK, {"epoch": self.epoch, "lsn": self.durable_lsn}))

    def _maybe_nack(self, src: str) -> None:
        self._msgs_since_nack += 1
        if self._msgs_since_nack >= self.nack_every:
            self._msgs_since_nack = 0
            self.endpoint.send(src, encode_msg(
                MSG_NACK, {"expect": self.durable_lsn + 1}))

    def _on_heartbeat(self, src: str, head: dict, now: float) -> None:
        if not self._check_epoch(src, int(head["epoch"])):
            return
        self.primary_id = src
        self.last_heard = now
        self.primary_lsn = max(self.primary_lsn, int(head["lsn"]))
        if self.index is None:
            # a lost CKPT_META/DONE would otherwise strand the bootstrap;
            # the primary's heartbeat doubles as the retry tick
            self._msgs_since_nack += 1
            if self._msgs_since_nack >= self.nack_every:
                self._msgs_since_nack = 0
                if self._boot is None:
                    self._hello(boot=True)
                else:
                    self._request_boot()
        elif self.lag() > 0:
            self._maybe_nack(src)

    # ------------------------------------------------------------ bootstrap
    def _boot_tmp(self) -> str:
        return os.path.join(self.root, "bootstrap.tmp")

    def _request_boot(self) -> None:
        if self.primary_id is None:
            return
        have = {}
        if self._boot is not None:
            have = {name: sorted(got)
                    for name, got in self._boot["got"].items()}
        self.endpoint.send(self.primary_id, encode_msg(
            MSG_BOOT_REQ, {"have": have}))

    def _resume_boot_from_disk(self) -> bool:
        """Rescan a half-finished bootstrap left by a crash: reload the
        manifest from ``MANIFEST.part`` and CRC-check every chunk already
        on disk, so the re-request ships only what is missing."""
        tmp = self._boot_tmp()
        part = os.path.join(tmp, BOOT_PART_NAME)
        if not os.path.exists(part):
            return False
        try:
            with open(part, "rb") as f:
                man = json.loads(f.read())
        except (OSError, ValueError):
            return False
        self._boot = {"man": man, "got": {}, "tmp": tmp}
        for name, entry in man["sections"].items():
            fpath = os.path.join(tmp, entry["file"])
            try:
                with open(fpath, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            cb = int(entry.get("chunk_bytes", STREAM_CHUNK_BYTES))
            crcs = entry.get("chunk_crcs") or []
            got = set()
            for ci, c in enumerate(crcs):
                if crc32(data[ci * cb:ci * cb + cb]) == c:
                    got.add(ci)
            if got:
                self._boot["got"][name] = got
        return True

    def _on_ckpt_meta(self, head: dict) -> None:
        man = head["manifest"]
        if self.index is not None:
            # the primary decided our local history diverged (stale epoch
            # or an unacked suffix past its tail): discard local state and
            # take the full stream — the Raft-truncation analogue
            if self.wal is not None:
                self.wal.close()
            self.wal = None
            self.index = None
            self._oo.clear()
        if self._boot is not None and self._boot["man"]["seq"] == man["seq"]:
            return  # resuming the same checkpoint: keep validated chunks
        tmp = self._boot_tmp()
        self.io.remove(tmp)
        self.io.mkdir(tmp)
        f = self.io.create(os.path.join(tmp, BOOT_PART_NAME))
        try:
            self.io.write(f, json.dumps(man, sort_keys=True).encode())
            self.io.fsync(f)
        finally:
            self.io.close(f)
        self._boot = {"man": man, "got": {}, "tmp": tmp}

    def _on_ckpt_chunk(self, head: dict, payload: bytes) -> None:
        if self._boot is None:
            return
        man = self._boot["man"]
        name = head["section"]
        entry = man["sections"].get(name)
        if entry is None or crc32(payload) != head["crc"]:
            return  # unknown/corrupt chunk: the DONE check re-requests it
        fpath = os.path.join(self._boot["tmp"], entry["file"])
        if not os.path.exists(fpath):
            f = self.io.create(fpath)
            try:
                self.io.write(f, b"\x00" * int(entry["nbytes"]))
            finally:
                self.io.close(f)
        with open(fpath, "r+b") as f:
            f.seek(int(head["off"]))
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        self._boot["got"].setdefault(name, set()).add(int(head["ci"]))

    def _boot_complete(self) -> bool:
        man = self._boot["man"]
        for name, entry in man["sections"].items():
            crcs = entry.get("chunk_crcs") or []
            got = self._boot["got"].get(name, set())
            if len(got) < len(crcs):
                return False
            fpath = os.path.join(self._boot["tmp"], entry["file"])
            try:
                with open(fpath, "rb") as f:
                    data = f.read()
            except OSError:
                return False
            if len(data) != entry["nbytes"] or crc32(data) != entry["crc32"]:
                return False
        return True

    def _on_ckpt_done(self, src: str, head: dict) -> None:
        if self._boot is None:
            return
        if not self._boot_complete():
            self._request_boot()  # only the missing chunks re-ship
            return
        man = self._boot["man"]
        tmp = self._boot["tmp"]
        # finalize: write the real manifest, fsync, atomic-rename into the
        # checkpoint directory — from here on this is a normal durable dir
        f = self.io.create(os.path.join(tmp, MANIFEST_NAME))
        try:
            self.io.write(f, json.dumps(man, sort_keys=True,
                                        indent=1).encode())
            self.io.fsync(f)
        finally:
            self.io.close(f)
        self.io.remove(os.path.join(tmp, BOOT_PART_NAME))
        self.io.fsync_dir(tmp)
        # discard any pre-existing local history BEFORE the new checkpoint
        # becomes visible: stale checkpoints (possibly with a higher seq)
        # and a diverged WAL must never outrank the streamed state.  A
        # crash in this window leaves no finalized checkpoint plus
        # ``bootstrap.tmp`` — exactly the resume path ``start()`` takes.
        for _seq, old in _ckpt.list_checkpoints(self.root):
            self.io.remove(old)
        wdir = _recovery.wal_dir(self.root)
        if os.path.exists(wdir):
            self.io.remove(wdir)
        ckdir = _ckpt.checkpoint_dir(self.root)
        self.io.mkdir(ckdir)
        final = os.path.join(ckdir, f"{_ckpt.CKPT_PREFIX}{man['seq']:08d}")
        self.io.replace(tmp, final)
        self.io.fsync_dir(ckdir)
        self._boot = None
        self.index = _ckpt.materialize(_ckpt.load_state(self.root),
                                       device=self.device)
        done_epoch = int(head.get("epoch", self.index._epoch))
        if done_epoch > self.epoch:
            self.epoch = done_epoch
        if self.epoch > self.index._epoch:
            self.index._epoch = self.epoch
        self.epoch = int(self.index._epoch)
        self.wal = WalWriter(
            _recovery.wal_dir(self.root), io=self.io,
            segment_bytes=self.segment_bytes, epoch=self.epoch,
            start_lsn=self.index._applied_lsn + 1)
        self.index._wal = self.wal
        self._send_ack(src)

    # ------------------------------------------------------------ promotion
    def promote(self, new_epoch: int | None = None) -> int:
        """Promote this replica: adopt an epoch strictly above everything
        it has observed and stamp it into the log (rotate) *before* any
        new-term record — the on-disk fence that refuses the old primary.
        Returns the new epoch."""
        if self.index is None or self.wal is None:
            raise RuntimeError(f"{self.node_id}: cannot promote before "
                               f"bootstrap completes")
        e = self.epoch + 1 if new_epoch is None else int(new_epoch)
        if not e > self.epoch:
            raise StaleEpochError(
                f"promotion epoch {e} must exceed observed epoch "
                f"{self.epoch}"
            )
        self.wal.set_epoch(e)
        self.epoch = e
        self.index._epoch = e
        return e

    def status(self) -> dict:
        return {
            "node": self.node_id,
            "role": "replica",
            "epoch": self.epoch,
            "lsn": self.durable_lsn,
            "primary_lsn": self.primary_lsn,
            "lag": self.lag(),
            "bootstrapping": self._boot is not None,
            "caught_up": self.caught_up(),
        }
