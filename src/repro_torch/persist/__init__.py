"""Durable index lifecycle of the port (``repro.persist``'s counterpart):
versioned checkpoints, the append-only write-ahead log, crash recovery,
the serve-from-checkpoint cold start and a fault-injection harness.  The
on-disk formats are those of ``PERSISTENCE.md``; a checkpoint or log
written by either package loads in the other.  Replication
(``repro.persist.replicate``) is not ported yet (ROADMAP A6b).
"""
from .checkpoint import (
    assert_index_equal,
    list_checkpoints,
    load,
    save,
    state_digest,
)
from .faultfs import (
    CrashError,
    EngineFaultPlan,
    FaultIO,
    OsIO,
    flip_bit,
    truncate_at,
)
from .format import STREAM_CHUNK_BYTES, CorruptError, chunk_crcs
from .recovery import (
    is_durable_dir,
    load_serving_snapshot,
    open_durable,
    recover,
    wal_dir,
)
from .wal import StaleEpochError, WalCorruptError, WalWriter, log_epoch

__all__ = [
    "CorruptError", "CrashError", "EngineFaultPlan", "FaultIO", "OsIO",
    "STREAM_CHUNK_BYTES", "StaleEpochError", "WalCorruptError", "WalWriter",
    "assert_index_equal", "chunk_crcs", "flip_bit", "is_durable_dir",
    "list_checkpoints", "load", "load_serving_snapshot", "log_epoch",
    "open_durable", "recover", "save", "state_digest", "truncate_at",
    "wal_dir",
]
