"""Append-only write-ahead log for ``WoWIndex`` mutations (the port's copy
of ``repro.persist.wal``: segments and records byte for byte the same).

Every durable mutation — an ``insert_batch`` micro-batch, a sequential
``insert``, ``delete``/``undelete``, a (manual or auto-triggered)
``compact_rows`` pass — appends one self-checksummed record *before* the
in-memory apply, and the record is fsynced before the mutating call
returns.  Recovery (``repro_torch.persist.recovery``) = newest valid
checkpoint + replay of the WAL suffix; replaying a record re-executes the
original index operation on the build backend the record names, and
because the index's RNG state rides in the checkpoint, replay reproduces
the live index bit for bit.  A record of the reference's ``"sharded"``
build replays on the ``"device"`` build (the reference's sharded build is
bitwise its device build at every shard count).

On-disk layout (all integers little-endian):

segment file ``wal-<seq:08d>.seg``::

    header (36 bytes):
      magic      8s   b"WOWWAL01"
      version    u32  1
      epoch      u32  fencing epoch/term (0 before replication existed;
                      the field was reserved-zero in v1 logs, so old
                      segments parse as epoch 0)
      seq        u64  segment sequence number
      start_lsn  u64  LSN of the segment's first record
      crc32      u32  over the preceding 32 bytes
    records, back to back::
      length     u32  len(body)
      crc32      u32  over body
      body:
        type     u8   record type (below)
        lsn      u64  log sequence number (monotone, gap-free)
        payload  type-specific (below)

Record types::

    1 INSERT      one insert_batch micro-batch:
                  u32 json_len + canonical JSON {backend, device_width,
                  shards} + .npy vectors (f32[B,d]) + .npy attrs (f64[B])
    2 DELETE      canonical JSON {vid}
    3 UNDELETE    canonical JSON {vid}
    4 COMPACT     empty (compact_rows is deterministic given index state)
    5 SEQ_INSERT  .npy vector (f32[d]) + .npy attr (f64[1])

Torn tails vs corruption: a crash can only tear the *tail* of the *last*
segment (records are appended then fsynced, and a new segment is created
only after its predecessor's records were all acked).  So an invalid
record is (a) a torn tail — iff it is in the last segment and no valid
record exists at any later byte offset — which recovery truncates away
cleanly, or (b) corruption (bit rot, manual tampering), which raises
``WalCorruptError``: a clean refusal, never a silently shortened log.
"""
from __future__ import annotations

import io as _io
import json
import os
import struct

import numpy as np

from .faultfs import OsIO
from .format import CorruptError, canonical_json, crc32, encode_npy

SEG_MAGIC = b"WOWWAL01"
SEG_VERSION = 1
SEG_HEADER_LEN = 36
REC_OVERHEAD = 8  # u32 length + u32 crc
MIN_BODY = 9  # u8 type + u64 lsn

T_INSERT = 1
T_DELETE = 2
T_UNDELETE = 3
T_COMPACT = 4
T_SEQ_INSERT = 5


class WalCorruptError(CorruptError):
    """Mid-log corruption (not a torn tail): recovery refuses to proceed."""


class StaleEpochError(WalCorruptError):
    """A fenced (stale-epoch) writer tried to touch a log that a higher
    epoch already owns — the old primary after a failover.  Refusing here
    is what makes split-brain unable to corrupt the record stream."""


def segment_name(seq: int) -> str:
    return f"wal-{seq:08d}.seg"


def list_segments(dirpath: str) -> list[tuple[int, str]]:
    """(seq, path) pairs of the directory's WAL segments, seq-ascending."""
    out = []
    if os.path.isdir(dirpath):
        for name in os.listdir(dirpath):
            if name.startswith("wal-") and name.endswith(".seg"):
                try:
                    seq = int(name[4:-4])
                except ValueError:
                    continue
                out.append((seq, os.path.join(dirpath, name)))
    out.sort()
    return out


# ------------------------------------------------------------------ payloads
def pack_insert(vectors: np.ndarray, attrs: np.ndarray, backend: str,
                device_width: int | None, shards: int | None) -> bytes:
    head = canonical_json(
        {"backend": backend, "device_width": device_width, "shards": shards}
    )
    return (
        struct.pack("<I", len(head)) + head
        + encode_npy(np.asarray(vectors, np.float32))
        + encode_npy(np.asarray(attrs, np.float64))
    )


def unpack_insert(payload: bytes) -> tuple[np.ndarray, np.ndarray, dict]:
    (jlen,) = struct.unpack_from("<I", payload)
    head = json.loads(payload[4 : 4 + jlen])
    buf = _io.BytesIO(payload[4 + jlen :])
    vectors = np.load(buf, allow_pickle=False)
    attrs = np.load(buf, allow_pickle=False)
    return vectors, attrs, head


def pack_seq_insert(vec: np.ndarray, attr: float) -> bytes:
    return encode_npy(np.asarray(vec, np.float32).reshape(-1)) + encode_npy(
        np.asarray([attr], np.float64)
    )


def unpack_seq_insert(payload: bytes) -> tuple[np.ndarray, float]:
    buf = _io.BytesIO(payload)
    vec = np.load(buf, allow_pickle=False)
    attr = np.load(buf, allow_pickle=False)
    return vec, float(attr[0])


# ------------------------------------------------------------------- records
def encode_record(rtype: int, lsn: int, payload: bytes) -> bytes:
    body = struct.pack("<BQ", rtype, lsn) + payload
    return struct.pack("<II", len(body), crc32(body)) + body


def _try_parse_record(data: bytes, off: int):
    """Parse one record at ``off``; returns (lsn, type, payload, end) or
    None when the bytes there do not form a valid record."""
    if off + REC_OVERHEAD > len(data):
        return None
    length, stated = struct.unpack_from("<II", data, off)
    if length < MIN_BODY or off + REC_OVERHEAD + length > len(data):
        return None
    body = data[off + REC_OVERHEAD : off + REC_OVERHEAD + length]
    if crc32(body) != stated:
        return None
    rtype, lsn = struct.unpack_from("<BQ", body)
    return lsn, rtype, body[MIN_BODY:], off + REC_OVERHEAD + length


def _probe_valid_record(data: bytes, from_off: int) -> bool:
    """True when ANY byte offset >= ``from_off`` parses as a valid record —
    the torn-tail/corruption discriminator: a genuine torn tail is a pure
    garbage suffix, so a valid record beyond the damage proves mid-log
    corruption."""
    for off in range(from_off, len(data) - REC_OVERHEAD - MIN_BODY + 1):
        if _try_parse_record(data, off) is not None:
            return True
    return False


def encode_segment_header(seq: int, start_lsn: int, epoch: int = 0) -> bytes:
    head = struct.pack("<8sIIQQ", SEG_MAGIC, SEG_VERSION, epoch, seq,
                       start_lsn)
    return head + struct.pack("<I", crc32(head))


def parse_segment_header(data: bytes) -> dict | None:
    if len(data) < SEG_HEADER_LEN:
        return None
    magic, version, epoch, seq, start_lsn = struct.unpack_from("<8sIIQQ", data)
    (stated,) = struct.unpack_from("<I", data, 32)
    if magic != SEG_MAGIC or version != SEG_VERSION:
        return None
    if crc32(data[:32]) != stated:
        return None
    return {"seq": seq, "start_lsn": start_lsn, "epoch": epoch}


def log_epoch(dirpath: str) -> int:
    """Highest segment-header epoch in ``dirpath`` (0 if empty/unreadable).
    Epochs are non-decreasing across segments, so this is the epoch the
    log's most recent writer held — recovery folds it into the index
    because a promotion rotates the WAL without writing a checkpoint."""
    best = 0
    for _seq, path in list_segments(dirpath):
        try:
            with open(path, "rb") as f:
                hdr = parse_segment_header(f.read(SEG_HEADER_LEN))
        except OSError:
            continue
        if hdr is not None and hdr["epoch"] > best:
            best = hdr["epoch"]
    return best


def scan_segment(path: str) -> dict:
    """Parse a segment file fully.  Returns::

        {"header": dict | None, "records": [(lsn, type, payload, end_off)],
         "bad_off": int | None,   # offset of the first invalid record
         "valid_beyond": bool,    # a valid record exists past bad_off
         "size": int}

    ``header=None`` means the 36-byte header itself failed validation
    (``bad_off`` is then 0 and ``valid_beyond`` probes from the header end).
    """
    with open(path, "rb") as f:
        data = f.read()
    header = parse_segment_header(data)
    if header is None:
        return {
            "header": None,
            "records": [],
            "bad_off": 0,
            "valid_beyond": _probe_valid_record(data, SEG_HEADER_LEN),
            "size": len(data),
        }
    records = []
    off = SEG_HEADER_LEN
    expect = header["start_lsn"]
    while off < len(data):
        rec = _try_parse_record(data, off)
        if rec is None:
            return {
                "header": header,
                "records": records,
                "bad_off": off,
                "valid_beyond": _probe_valid_record(data, off + 1),
                "size": len(data),
            }
        lsn, rtype, payload, end = rec
        if lsn != expect:
            # a checksummed record with the wrong LSN is never a torn
            # tail — flag it as corruption via valid_beyond
            return {
                "header": header,
                "records": records,
                "bad_off": off,
                "valid_beyond": True,
                "size": len(data),
            }
        records.append((lsn, rtype, payload, end))
        expect += 1
        off = end
    return {
        "header": header,
        "records": records,
        "bad_off": None,
        "valid_beyond": False,
        "size": len(data),
    }


# -------------------------------------------------------------------- writer
class WalWriter:
    """Appends self-checksummed records to the newest segment, fsyncing
    each before returning its LSN (log -> fsync -> apply discipline lives
    in the `WoWIndex` hooks).  Rotation starts a fresh segment once the
    current one exceeds ``segment_bytes`` (and on every checkpoint, so
    pruning works at segment granularity)."""

    def __init__(self, dirpath: str, io: OsIO | None = None,
                 segment_bytes: int = 4 << 20, epoch: int | None = None,
                 start_lsn: int = 1):
        """``epoch=None`` adopts the newest segment's epoch (0 for a fresh
        log).  An explicit epoch below the log's is refused with
        ``StaleEpochError`` — a fenced ex-primary reopening a log its
        successor already wrote; an explicit epoch above it rotates
        immediately so the promotion is stamped on disk before any append.
        ``start_lsn`` seeds the first segment of an *empty* directory — a
        bootstrapped replica's WAL starts at its checkpoint LSN + 1, not
        at 1 — and is ignored when segments exist."""
        self.dir = dirpath
        self.io = io or OsIO()
        self.segment_bytes = segment_bytes
        self.io.mkdir(dirpath)
        self._f = None
        self._size = 0
        segs = list_segments(dirpath)
        if segs:
            segs = self._verify_chain(segs)
        if not segs:
            self.next_lsn = start_lsn
            self._seq = -1
            self.epoch = 0 if epoch is None else epoch
            self.rotate()
            return
        seq, path = segs[-1]
        scan = scan_segment(path)
        if scan["bad_off"] is not None or scan["header"] is None:
            raise WalCorruptError(
                f"cannot append to {path}: invalid tail at offset "
                f"{scan['bad_off']} (run recovery first)"
            )
        tail_epoch = scan["header"]["epoch"]
        if epoch is not None and epoch < tail_epoch:
            raise StaleEpochError(
                f"cannot append to {path}: writer epoch {epoch} is behind "
                f"log epoch {tail_epoch} (fenced by a newer primary)"
            )
        self.epoch = tail_epoch if epoch is None else epoch
        self._seq = seq
        self.next_lsn = (
            scan["records"][-1][0] + 1 if scan["records"]
            else scan["header"]["start_lsn"]
        )
        if self.epoch > tail_epoch:
            # stamp the promotion before any append lands in the log
            self.rotate()
            return
        self._f = self.io.open_append(path)
        self._size = scan["size"]

    def _verify_chain(self, segs: list[tuple[int, str]]):
        """Cross-segment epoch + LSN continuity for the WHOLE chain on
        reopen (``read_log`` checks this on the recovery path; a writer
        reopening after a ``prune()``/``rotate()`` crash must not trust the
        tail segment alone).  A torn *final* header — the crash landed
        mid-``rotate``, before the new segment's header was fully written
        and with no records in it — is removed so the previous segment
        becomes the tail again; anything else invalid raises."""
        prev_end: int | None = None
        prev_epoch: int | None = None
        for i, (seq, path) in enumerate(segs):
            last = i == len(segs) - 1
            scan = scan_segment(path)
            hdr = scan["header"]
            if hdr is None:
                if last and not scan["valid_beyond"]:
                    self.io.remove(path)
                    self.io.fsync_dir(self.dir)
                    return segs[:-1]
                raise WalCorruptError(f"{path}: invalid segment header")
            if scan["bad_off"] is not None and not last:
                raise WalCorruptError(
                    f"{path}: invalid record at offset {scan['bad_off']} in "
                    f"a non-final segment (run recovery first)"
                )
            if prev_epoch is not None and hdr["epoch"] < prev_epoch:
                raise WalCorruptError(
                    f"{path}: epoch went backwards ({prev_epoch} -> "
                    f"{hdr['epoch']})"
                )
            if prev_end is not None and hdr["start_lsn"] != prev_end:
                raise WalCorruptError(
                    f"{path}: start_lsn {hdr['start_lsn']} breaks LSN "
                    f"continuity (previous segment ended at {prev_end})"
                )
            prev_end = (
                scan["records"][-1][0] + 1 if scan["records"]
                else hdr["start_lsn"]
            )
            prev_epoch = hdr["epoch"]
        return segs

    def rotate(self) -> None:
        """Close the current segment and start ``seq+1`` at ``next_lsn``,
        stamped with the writer's current epoch."""
        if self._f is not None:
            self.io.fsync(self._f)
            self.io.close(self._f)
        self._seq += 1
        path = os.path.join(self.dir, segment_name(self._seq))
        self._f = self.io.create(path)
        hdr = encode_segment_header(self._seq, self.next_lsn, self.epoch)
        self.io.write(self._f, hdr)
        self.io.fsync(self._f)
        self.io.fsync_dir(self.dir)
        self._size = len(hdr)

    def set_epoch(self, epoch: int) -> None:
        """Adopt a higher epoch, rotating so the fence is on disk before
        any record of the new term.  Moving backwards is refused; equal is
        a no-op (epoch comparisons are strict by contract)."""
        if epoch < self.epoch:
            raise StaleEpochError(
                f"epoch may not move backwards ({self.epoch} -> {epoch})"
            )
        if epoch > self.epoch:
            self.epoch = epoch
            self.rotate()

    def append(self, rtype: int, payload: bytes = b"",
               fsync: bool = True) -> int:
        """Append one record; returns its LSN.  With ``fsync`` (default)
        the record is durable when this returns.  ``fsync=False`` is the
        group-commit half: the caller batches several appends and makes
        them all durable with one ``sync()`` — the serve engine's ingest
        admission logs every queued micro-batch this way and acks after a
        single fsync, so durability order still equals admission order at
        a fraction of the fsync cost.  A crash before the ``sync()``
        tears an *unacked* suffix, which recovery truncates like any torn
        tail."""
        if self._size >= self.segment_bytes:
            self.rotate()
        lsn = self.next_lsn
        rec = encode_record(rtype, lsn, payload)
        self.io.write(self._f, rec)
        if fsync:
            self.io.fsync(self._f)
        self._size += len(rec)
        self.next_lsn = lsn + 1
        return lsn

    def sync(self) -> None:
        """Make every appended record durable (the group-commit barrier)."""
        if self._f is not None:
            self.io.fsync(self._f)

    # typed appends (the WoWIndex hooks call these)
    def log_insert(self, vectors, attrs, backend: str,
                   device_width: int | None, shards: int | None,
                   fsync: bool = True) -> int:
        return self.append(
            T_INSERT,
            pack_insert(vectors, attrs, backend, device_width, shards),
            fsync=fsync,
        )

    def log_seq_insert(self, vec, attr: float) -> int:
        return self.append(T_SEQ_INSERT, pack_seq_insert(vec, attr))

    def log_delete(self, vid: int) -> int:
        return self.append(T_DELETE, canonical_json({"vid": int(vid)}))

    def log_undelete(self, vid: int) -> int:
        return self.append(T_UNDELETE, canonical_json({"vid": int(vid)}))

    def log_compact(self) -> int:
        return self.append(T_COMPACT)

    def prune(self, keep_from_lsn: int) -> int:
        """Delete segments whose records are ALL <= ``keep_from_lsn`` (i.e.
        already covered by every retained checkpoint).  The last segment is
        never deleted.  Returns the number of segments removed."""
        segs = list_segments(self.dir)
        removed = 0
        for i, (seq, path) in enumerate(segs[:-1]):
            nxt_scan = scan_segment(segs[i + 1][1])
            nxt_start = (
                nxt_scan["header"]["start_lsn"] if nxt_scan["header"] else None
            )
            if nxt_start is not None and nxt_start <= keep_from_lsn + 1:
                self.io.remove(path)
                removed += 1
            else:
                break  # segments are lsn-ordered: nothing older is prunable
        if removed:
            self.io.fsync_dir(self.dir)
        return removed

    def close(self) -> None:
        if self._f is not None:
            self.io.fsync(self._f)
            self.io.close(self._f)
            self._f = None


# -------------------------------------------------------------------- replay
def read_log(dirpath: str, io: OsIO | None = None,
             truncate_torn: bool = True) -> list[tuple[int, int, bytes]]:
    """Validate the whole log and return its records as (lsn, type,
    payload), lsn-ascending and gap-free.

    Torn tails (invalid suffix of the LAST segment with nothing valid
    beyond it) are truncated away when ``truncate_torn`` — the recovery
    path — so a subsequent ``WalWriter`` can append cleanly.  Anything
    else invalid raises ``WalCorruptError``.
    """
    io = io or OsIO()
    segs = list_segments(dirpath)
    out: list[tuple[int, int, bytes]] = []
    expect: int | None = None
    for i, (seq, path) in enumerate(segs):
        last = i == len(segs) - 1
        scan = scan_segment(path)
        if scan["header"] is None:
            if not last or scan["valid_beyond"]:
                raise WalCorruptError(f"{path}: invalid segment header")
            # torn segment creation: header never fully landed, no records
            if truncate_torn:
                io.remove(path)
            break
        if scan["bad_off"] is not None:
            if not last or scan["valid_beyond"]:
                raise WalCorruptError(
                    f"{path}: invalid record at offset {scan['bad_off']} "
                    f"with valid data beyond it (corruption, not a torn tail)"
                )
            if truncate_torn:
                io.truncate(path, scan["bad_off"])
        if scan["records"]:
            first = scan["records"][0][0]
            if expect is not None and first != expect:
                raise WalCorruptError(
                    f"{path}: LSN gap (expected {expect}, found {first})"
                )
            out.extend((l, t, p) for l, t, p, _ in scan["records"])
            expect = scan["records"][-1][0] + 1
        elif expect is not None and scan["header"]["start_lsn"] > expect:
            raise WalCorruptError(
                f"{path}: start_lsn {scan['header']['start_lsn']} leaves an "
                f"LSN gap (expected {expect})"
            )
    return out


def apply_record(index, rtype: int, payload: bytes) -> None:
    """Re-execute one logged mutation on ``index`` (replay mode: the index
    must have ``_wal_replaying`` set so the apply neither re-logs nor
    re-triggers auto-compaction — compactions replay via their own
    records)."""
    if rtype == T_INSERT:
        vectors, attrs, head = unpack_insert(payload)
        backend = head["backend"]
        if backend == "sharded":
            # the sharded build is bitwise the device build at every shard
            # count, so replay is device-count independent (the port has
            # no sharded build: ROADMAP A8)
            backend = "device"
        index.insert_batch(
            vectors, attrs, batch_size=max(len(attrs), 1), backend=backend,
            device_width=head["device_width"],
        )
    elif rtype == T_SEQ_INSERT:
        vec, attr = unpack_seq_insert(payload)
        index.insert(vec, attr)
    elif rtype == T_DELETE:
        index.delete(json.loads(payload)["vid"])
    elif rtype == T_UNDELETE:
        index.undelete(json.loads(payload)["vid"])
    elif rtype == T_COMPACT:
        index.compact_rows()
    else:
        raise WalCorruptError(f"unknown WAL record type {rtype}")
