"""Crash recovery + the durable index lifecycle entry points (the port of
``repro.persist.recovery``).

``recover(root)`` = newest valid checkpoint + replay of the valid WAL
suffix (records with LSN beyond the checkpoint), truncating torn tails
cleanly; mid-log corruption raises instead of yielding a silently shorter
history.  ``open_durable(root)`` wraps it into the full lifecycle: create
or recover the index and attach a live ``WalWriter`` so every subsequent
mutation is logged-then-applied.  ``load_serving_snapshot(root)`` is the
serve-from-checkpoint cold start: CRC-validated ``np.load(mmap_mode="r")``
slabs wrapped directly into a serving ``Snapshot`` — no graph replay, no
host index, first query served before the slabs are fully paged in.

``device`` (``recover``, ``open_durable``) is the recovered index's build
device, as ``WoWIndex(device=)`` takes it: None is the CUDA card, where a
replayed ``"device"``/``"ops"`` insert record runs the build through the
``gather_norm_dot`` kernel.
"""
from __future__ import annotations

import logging
import os

from . import checkpoint, wal
from .faultfs import OsIO
from .format import CorruptError

log = logging.getLogger("repro_torch.persist")

WAL_SUBDIR = "wal"


def wal_dir(root: str) -> str:
    return os.path.join(root, WAL_SUBDIR)


def is_durable_dir(root: str) -> bool:
    """True when ``root`` holds an index lifecycle (any checkpoint)."""
    return bool(checkpoint.list_checkpoints(root))


def recover(root: str, io: OsIO | None = None, upto_lsn: int | None = None,
            device=None):
    """Restore the newest recoverable index state: newest valid checkpoint
    chain, then replay every WAL record with ``lsn > checkpoint.lsn``.

    ``upto_lsn`` stops replay at that LSN (inclusive) — the replication
    tests use it to compare a fenced primary's disk state against a
    promoted replica *at the promotion LSN*, where the two must be
    bitwise-equal even though the primary's log carries unacked records
    beyond it.  Requires ``upto_lsn >= checkpoint.lsn`` (a checkpoint
    cannot be un-applied).

    Returns the recovered ``WoWIndex`` (no WAL attached — use
    ``open_durable`` to continue mutating durably).  Raises
    ``CorruptError``/``WalCorruptError`` when neither a valid checkpoint
    exists nor the log validates — a clean refusal, never a corrupt index.
    """
    io = io or OsIO()
    index = checkpoint.materialize(checkpoint.load_state(root),
                                   device=device)
    records = wal.read_log(wal_dir(root), io=io)
    base_lsn = index._applied_lsn
    if upto_lsn is not None and upto_lsn < base_lsn:
        raise ValueError(
            f"upto_lsn {upto_lsn} precedes the newest checkpoint "
            f"(lsn {base_lsn}); checkpoints cannot be un-applied"
        )
    pending = [(l, t, p) for l, t, p in records
               if l > base_lsn and (upto_lsn is None or l <= upto_lsn)]
    if pending and pending[0][0] != base_lsn + 1:
        raise wal.WalCorruptError(
            f"WAL starts at LSN {pending[0][0]} but checkpoint covers "
            f"through {base_lsn}: log has a gap"
        )
    n0 = index.store.n
    index._wal_replaying = True
    try:
        for lsn, rtype, payload in pending:
            wal.apply_record(index, rtype, payload)
            index._applied_lsn = lsn
    finally:
        index._wal_replaying = False
    index._replayed_rows = index.store.n - n0
    # the fencing epoch rides both the checkpoint manifest and the WAL
    # segment headers (a promotion rotates the log without checkpointing,
    # so the log can be ahead of the manifest — never behind)
    seg_epoch = wal.log_epoch(wal_dir(root))
    if seg_epoch > index._epoch:
        index._epoch = seg_epoch
    if pending:
        log.info("recovered %s: checkpoint lsn %d + %d WAL records",
                 root, base_lsn, len(pending))
    return index


def open_durable(root: str, io: OsIO | None = None, create: dict | None = None,
                 compact_threshold: float | None = None,
                 segment_bytes: int = 4 << 20, device=None):
    """Open (or create) a durable index at ``root`` and attach its WAL.

    Existing lifecycle: ``recover`` then append to the log.  Fresh
    directory: ``create`` must hold ``WoWIndex`` constructor kwargs (at least
    ``dim``); an empty *initial checkpoint* is written immediately so the
    index parameters are durable before the first WAL record.
    """
    io = io or OsIO()
    if is_durable_dir(root):
        index = recover(root, io=io, device=device)
    else:
        if create is None:
            raise ValueError(
                f"{root} holds no index; pass create={{'dim': ...}} to "
                f"initialize one"
            )
        from ..core.index import WoWIndex

        index = WoWIndex(**create, device=device)
        checkpoint.save(index, root, io=io)
    if compact_threshold is not None:
        index.compact_threshold = compact_threshold
    index._wal = wal.WalWriter(wal_dir(root), io=io,
                               segment_bytes=segment_bytes,
                               epoch=index._epoch)
    # a torn tail was truncated by recover(); the writer continues from
    # the last valid record, which must line up with what we replayed
    if index._wal.next_lsn != index._applied_lsn + 1:
        raise wal.WalCorruptError(
            f"WAL writer resumes at LSN {index._wal.next_lsn} but the "
            f"recovered index applied through {index._applied_lsn}"
        )
    return index


def load_serving_snapshot(root: str):
    """Serve-from-checkpoint cold start: build a serving ``Snapshot``
    straight from the newest valid checkpoint's slabs.

    Full checkpoints are memory mapped (``np.load(mmap_mode="r")`` after
    CRC validation), so the first query runs before the vector/adjacency
    slabs are fully paged in; delta chains compose in memory.  The
    snapshot reflects the *checkpoint* — WAL records past it need a full
    ``recover()`` (the serving engine does that lazily on first mutation).

    Returns ``(snapshot, meta)``.
    """
    from ..core.snapshot import snapshot_from_arrays

    state = checkpoint.load_state(root, mmap=True)
    meta = state["meta"]
    if meta["n"] == 0:
        raise CorruptError("cannot serve from an empty checkpoint")
    snap = snapshot_from_arrays(
        vectors=state["vectors"],
        sq_norms=state["sq_norms"],
        attrs=state["attrs"],
        neighbors=state["neighbors"],
        deleted=state["deleted"],
        m=meta["m"],
        o=meta["o"],
        metric=meta["metric"],
        stamp=meta["mutations"],
        # format-v2 quantized slabs (when the writer ran vec_dtype != f32):
        # the device upload reuses them directly, skipping re-quantization
        q_vectors=state.get("q_vectors"),
        q_scales=state.get("q_scales"),
        vec_dtype=meta.get("vec_dtype", "f32"),
    )
    return snap, meta
