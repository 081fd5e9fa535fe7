"""Serving surfaces of the port: ``engine.LMServer`` (LM prefill/decode),
``engine.RagPipeline`` (retrieval over a WoW index) and the
request-lifecycle ``lifecycle.ServeEngine``."""
from .engine import LMServer, RagPipeline
from .lifecycle import (
    EngineConfig, IngestResult, Rejected, Reply, ServeEngine, ServeStats,
    Ticket,
)

__all__ = ["EngineConfig", "IngestResult", "LMServer", "RagPipeline",
           "Rejected", "Reply", "ServeEngine", "ServeStats", "Ticket"]
