"""Serving surfaces of the port: ``engine.LMServer`` (LM prefill/decode).
``RagPipeline`` and the request-lifecycle ``ServeEngine`` come later
(ROADMAP A3, A7)."""
from .engine import LMServer

__all__ = ["LMServer"]
