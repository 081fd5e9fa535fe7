"""Serving surfaces of the port: ``engine.LMServer`` (LM prefill/decode),
``engine.RagPipeline`` (retrieval over a WoW index), the
request-lifecycle ``lifecycle.ServeEngine`` and the replicated
``cluster.Cluster``."""
from .cluster import Cluster, ClusterMember, ClusterReply, ClusterTicket
from .engine import LMServer, RagPipeline
from .lifecycle import (
    EngineConfig, IngestResult, Rejected, Reply, ServeEngine, ServeStats,
    Ticket,
)

__all__ = ["Cluster", "ClusterMember", "ClusterReply", "ClusterTicket",
           "EngineConfig", "IngestResult", "LMServer", "RagPipeline",
           "Rejected", "Reply", "ServeEngine", "ServeStats", "Ticket"]
