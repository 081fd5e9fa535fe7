"""Durable index lifecycle of the port (``repro.persist``'s counterpart):
versioned checkpoints, the append-only write-ahead log, crash recovery,
the serve-from-checkpoint cold start, a fault-injection harness and
replication (WAL shipping, quorum-durable acks, streamed bootstrap, epoch
fencing).  The on-disk formats and the replication frames are those of
``PERSISTENCE.md`` and ``repro.persist``; a checkpoint or log written by
either package loads in the other, and a primary of either package feeds a
replica of the other.
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
from .replicate import (
    FaultSchedule,
    FaultTransport,
    InProcEndpoint,
    InProcTransport,
    PrimaryReplicator,
    QuorumTimeoutError,
    ReplicaReplicator,
    ReplicatedWal,
    SocketEndpoint,
)
from .wal import StaleEpochError, WalCorruptError, WalWriter, log_epoch

__all__ = [
    "CorruptError", "CrashError", "EngineFaultPlan", "FaultIO",
    "FaultSchedule", "FaultTransport", "InProcEndpoint", "InProcTransport",
    "OsIO", "PrimaryReplicator", "QuorumTimeoutError", "ReplicaReplicator",
    "ReplicatedWal", "STREAM_CHUNK_BYTES", "SocketEndpoint",
    "StaleEpochError", "WalCorruptError", "WalWriter", "assert_index_equal",
    "chunk_crcs", "flip_bit", "is_durable_dir", "list_checkpoints", "load",
    "load_serving_snapshot", "log_epoch", "open_durable", "recover", "save",
    "state_digest", "truncate_at", "wal_dir",
]
