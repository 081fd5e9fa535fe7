"""Serving engine: the LM prefill/decode loop and WoW retrieval (RAG), the
port of ``repro.serve.engine``.

``LMServer`` wraps an arch's prefill and decode steps with a KV/RWKV state
and greedy or temperature sampling, and pools the final-token distribution
into a retrieval embedding.  Unlike the JAX server, which calls ``forward``
with its ``backend="ref"`` default, it passes its ``backend`` through, so
on the card a served model runs the flash-attention and WKV kernels.

``RagPipeline`` composes it with a WoW index: the LM embeds documents and
queries, WoW retrieves the nearest in-range documents.  ``retrieve_batch``
is the synchronous surface (one call, one wave); ``engine()`` builds a
request-lifecycle ``ServeEngine`` (``serve.lifecycle``) over the same
index, knobs and ``ServeStats``.  Retrieval runs on the server's device.
With ``index_dir`` the pipeline rides the durable lifecycle
(``repro_torch.persist``): a cold start off the newest checkpoint, lazy
recovery at the first mutation, a write-ahead-logged ingest and
``checkpoint()``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..models.model import ParamTree, forward, init_cache
from .lifecycle import IngestResult, ServeStats, validate_rows


class LMServer:
    """Serve ``params`` of arch ``cfg`` on ``device`` (``None`` = the card;
    raises without CUDA).  ``backend`` follows ``kernels.ops``: "auto" runs
    the kernels on CUDA tensors, "ref" the plain versions.

    ``last_run`` describes the last ``generate``: the prefill's
    last-position logits (``prefill_logits`` [B, V] f32), the top-2 margin
    of the logits each token was picked from (``margins`` [B, steps]; a
    small one marks a near tie), and the host-clock split ``prefill_s``
    (to the first token on the host), ``decode_s`` over ``decode_steps``
    decodes."""

    def __init__(self, cfg: ArchConfig, params: ParamTree, max_len: int = 512,
                 compute_dtype=torch.float32, device=None,
                 backend: str = "auto"):
        self.device = resolve_device(device)
        self.cfg, self.max_len = cfg, max_len
        self.params = params.to(self.device)
        self.dtype = compute_dtype
        self.backend = backend
        self.last_run: dict = {}

    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor):
        caches = init_cache(self.cfg, tokens.shape[0], self.max_len,
                            self.dtype, device=self.device)
        logits, caches, _ = forward(
            self.params, self.cfg, tokens, mode="prefill", caches=caches,
            cache_len=self.max_len, backend=self.backend,
            compute_dtype=self.dtype, last_only=True)
        return logits[:, -1], caches

    @torch.inference_mode()
    def _decode(self, tok: torch.Tensor, pos: torch.Tensor, caches: list):
        logits, caches, _ = forward(
            self.params, self.cfg, tok, mode="decode", caches=caches,
            pos=pos, cache_len=self.max_len, backend=self.backend,
            compute_dtype=self.dtype)
        return logits[:, -1], caches

    def generate(self, prompts: np.ndarray, steps: int = 16,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """prompts [B, T] int32 -> generated [B, steps] int32 (greedy, or
        sampled at ``temperature`` from a ``torch.Generator`` seeded with
        ``seed``).  The decode after the last token, which the JAX loop
        runs and discards, is skipped."""
        B, T = prompts.shape
        tokens = torch.as_tensor(np.asarray(prompts, np.int32),
                                 device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = np.zeros((B, steps), np.int32)
        margins = np.zeros((B, steps), np.float32)
        pos = torch.full((B,), T, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        logits, caches = self._prefill(tokens)
        first = logits.float()
        t_first = None
        for s in range(steps):
            lf = logits.float()
            if temperature > 0:
                probs = torch.softmax(lf / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(lf, dim=-1)
            out[:, s] = tok.cpu().numpy()  # waits for the device
            top2 = torch.topk(lf, 2, dim=-1).values
            margins[:, s] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            if t_first is None:
                t_first = time.perf_counter()
            if s + 1 < steps:
                logits, caches = self._decode(
                    tok[:, None].to(torch.int32), pos, caches)
                pos = pos + 1
        t_end = time.perf_counter()
        self.last_run = {"prefill_logits": first, "margins": margins,
                         "prefill_s": (t_first or t_end) - t0,
                         "decode_s": t_end - (t_first or t_end),
                         "decode_steps": max(steps - 1, 0)}
        return out

    @torch.inference_mode()
    def embed(self, tokens: np.ndarray) -> np.ndarray:
        """The final-token distribution pooled through the embedding table,
        ``softmax(logits[:, -1]) @ embed``, as a retrieval embedding
        [B, d] f32 (the JAX method's pooling; the trunk runs in train mode,
        so attention goes through the flash kernel)."""
        toks = torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)
        logits, _, _ = forward(self.params, self.cfg, toks, mode="train",
                               backend=self.backend,
                               compute_dtype=self.dtype, last_only=True)
        probs = torch.softmax(logits[:, -1].float(), dim=-1)
        emb = probs @ self.params["embed"].float()
        return emb.cpu().numpy().astype(np.float32)


class RagPipeline:
    """WoW-backed range-filtered retrieval for LM serving.

    ``backend`` selects the distance-kernel dispatch of the batched device
    path (``kernels.ops``: "auto" = the CUDA kernel on CUDA tensors, plain
    torch on CPU tensors); single-query ``retrieve`` stays on the host
    index.  ``build_backend`` selects the ``insert_batch`` engine for
    ingest-while-serve (``"device"`` = the device-resident build, on the
    server's device).  ``visited``/``compact`` are the ``device_search``
    hop-loop knobs; with ``visited_adaptive`` the hash filter is re-sized
    from the measured hop counts of the last 16 batches (worst-case sizing
    is the cold-start fallback).  Batches are pow2-padded inside
    ``search_batch``.
    """

    def __init__(self, server: LMServer, dim: int, m: int = 16,
                 ef_construction: int = 64, o: int = 4, backend: str = "auto",
                 visited: str = "bitmap",
                 compact: tuple[int, int] | None = None,
                 build_backend: str = "numpy",
                 visited_adaptive: bool = False,
                 index_dir: str | None = None,
                 compact_threshold: float | None = None,
                 vec_dtype: str = "f32"):
        """``index_dir`` switches the pipeline to the durable lifecycle
        (``repro_torch.persist``): when the directory already holds
        checkpoints, the serving snapshot cold-starts straight from the
        newest one's memory-mapped slabs — the first ``retrieve_batch``
        answers without rebuilding the graph — and the host index is only
        recovered (checkpoint + WAL replay, on the server's device) at the
        first call that mutates or needs it (``add_documents``,
        ``retrieve``, ``checkpoint``, ``engine``).  Ingest then rides the
        WAL: each micro-batch is logged and fsynced before it is applied.
        ``compact_threshold`` is the background compaction cadence
        (tombstone fraction)."""
        from ..core.store import VEC_DTYPES

        if vec_dtype not in VEC_DTYPES:
            raise ValueError(
                f"vec_dtype must be one of {VEC_DTYPES}, got {vec_dtype!r}"
            )
        self.server = server
        self.docs: list = []
        self.backend = backend
        # serving slab storage mode (int8/bf16 dequant fused in the gather
        # kernel) with the f32 host index as the build/parity oracle
        self.vec_dtype = vec_dtype
        self.visited = visited
        self.compact = compact
        self.build_backend = build_backend
        self.visited_adaptive = visited_adaptive
        self.index_dir = index_dir
        self.compact_threshold = compact_threshold
        self._hop_log: list = []  # rolling hop counts (serve feedback)
        self._stats = ServeStats()
        self._snap = None
        self._snap_key = None
        self._index = None
        if index_dir is not None:
            from ..persist import is_durable_dir, load_serving_snapshot

            self._create = dict(dim=dim, m=m, ef_construction=ef_construction,
                                o=o, compact_threshold=compact_threshold)
            if is_durable_dir(index_dir):
                self._snap, meta = load_serving_snapshot(index_dir)
                if meta["dim"] != dim:
                    raise ValueError(
                        f"index at {index_dir} has dim {meta['dim']}, "
                        f"pipeline expects {dim}"
                    )
        else:
            from ..core import WoWIndex

            self._index = WoWIndex(dim=dim, m=m,
                                   ef_construction=ef_construction, o=o,
                                   compact_threshold=compact_threshold,
                                   device=server.device)

    @property
    def index(self):
        """The live host index; in durable mode the first access runs full
        crash recovery (checkpoint + WAL replay) and attaches the WAL."""
        if self._index is None:
            from ..persist import open_durable

            self._index = open_durable(
                self.index_dir, create=self._create,
                compact_threshold=self.compact_threshold,
                device=self.server.device,
            )
        return self._index

    def checkpoint(self) -> str:
        """Durable mode: write a (full or incremental) checkpoint of the
        live index to ``index_dir``; returns the checkpoint path."""
        if self.index_dir is None:
            raise RuntimeError("RagPipeline has no index_dir")
        return self.index.checkpoint(self.index_dir)

    def add_document(self, doc_tokens: np.ndarray, attr: float,
                     payload=None) -> int:
        emb = self.server.embed(doc_tokens[None, :])[0]
        vid = self.index.insert(emb, attr)
        self.docs.append(payload)
        return vid

    def add_documents(self, doc_tokens: np.ndarray, attrs, payloads=None,
                      batch_size: int = 128) -> IngestResult:
        """Ingest-while-serve: one batched embed pass + ``insert_batch``
        micro-batches.  The serving snapshot is refreshed lazily by the
        next ``retrieve_batch``.  Rows are validated individually: a
        half-bad batch commits its good rows and reports the bad ones in
        ``IngestResult.rejected``; structural errors (payload/attr length,
        embedding dimension) raise."""
        doc_tokens = np.asarray(doc_tokens)
        attrs = np.asarray(attrs, dtype=np.float64).reshape(-1)
        if payloads is not None and len(payloads) != len(attrs):
            raise ValueError(
                f"{len(payloads)} payloads for {len(attrs)} documents"
            )
        embs = self.server.embed(doc_tokens)
        keep, rejected = validate_rows(embs, attrs, self.index.dim)
        vids = np.empty(0, np.int64)
        if keep.any():
            vids = self.index.insert_batch(
                embs[keep], attrs[keep], batch_size=batch_size,
                backend=self.build_backend,
            )
        if payloads is None:
            payloads = [None] * len(attrs)
        self.docs.extend(p for p, ok in zip(payloads, keep) if ok)
        self._stats.ingest_batches += 1
        self._stats.ingest_rows += int(keep.sum())
        self._stats.ingest_rejected_rows += len(rejected)
        return IngestResult(
            vids=vids, accepted=int(keep.sum()), rejected=rejected,
            lsn=self.index._applied_lsn, pending=False,
        )

    def stats(self) -> dict:
        """Serving statistics of both surfaces (a ``ServeEngine`` built by
        ``engine()`` feeds the same ``ServeStats``): per-request latency
        percentiles and QPS (admission -> reply), degraded/shed fractions,
        ingest accounting."""
        out = self._stats.summary()
        out["docs"] = len(self.docs)
        out["index_size"] = len(self._index) if self._index is not None else 0
        return out

    def engine(self, config=None, now=None, fault_plan=None, **knobs):
        """A request-lifecycle ``ServeEngine`` over this pipeline's index
        on the server's device, inheriting its search/build knobs (override
        any ``EngineConfig`` field through ``knobs``) and sharing its
        ``ServeStats``; the current serving snapshot is handed over.  In
        durable mode this recovers the host index first (ingest needs
        it)."""
        from .lifecycle import EngineConfig, ServeEngine

        if config is None:
            base = dict(backend=self.backend, visited=self.visited,
                        adaptive=self.visited_adaptive,
                        build_backend=self.build_backend,
                        vec_dtype=self.vec_dtype)
            base.update(knobs)
            config = EngineConfig(**base)
        elif knobs:
            raise ValueError("pass either config= or **knobs, not both")
        return ServeEngine(index=self.index, snapshot=self._snap,
                           config=config, now=now, fault_plan=fault_plan,
                           stats=self._stats, device=self.server.device)

    def retrieve(self, query_tokens: np.ndarray,
                 attr_range: tuple[float, float], k: int = 5, ef: int = 48):
        q = self.server.embed(query_tokens[None, :])[0]
        ids, dists, stats = self.index.search(q, attr_range, k=k, ef=ef)
        return ids, dists, stats

    def retrieve_batch(self, query_tokens: np.ndarray,
                       attr_ranges: np.ndarray, k: int = 5, width: int = 48):
        """Batched retrieval on the device path (fused hop pipeline), on
        the server's device.

        ``query_tokens`` [B, T] int32, ``attr_ranges`` [B, 2] -> (ids,
        dists), ids mapped back to ``WoWIndex`` vertex ids (-1 padded).
        The snapshot is taken lazily and reused until the index mutates;
        the refresh is incremental (``take_snapshot(prev=...)``)."""
        from ..core.device_search import (
            search_batch, visited_filter_bits_measured,
        )
        from ..core.snapshot import take_snapshot

        t_arrival = time.monotonic()
        # the index's monotone mutation stamp changes on any insert/delete/
        # undelete (sizes alone would miss an undelete+delete pair).  In
        # durable cold-start mode the host index may not be recovered yet
        # (self._index is None): serve straight off the checkpoint snapshot
        # and refresh only once a live index exists and has mutated.
        if self._index is not None:
            key = self._index.mutations
            if self._snap is None or self._snap_key != key:
                self._snap = take_snapshot(self._index, prev=self._snap)
                self._snap_key = key
        elif self._snap is None:
            raise RuntimeError("no serving snapshot: index_dir holds no data")
        qs = self.server.embed(query_tokens)
        visited_bits = None
        if self.visited == "hash" and self.visited_adaptive and self._hop_log:
            visited_bits = visited_filter_bits_measured(
                np.concatenate(self._hop_log), self._snap.m
            )
        res = search_batch(self._snap, qs, np.asarray(attr_ranges, np.float32),
                           k=k, width=width, backend=self.backend,
                           visited=self.visited, visited_bits=visited_bits,
                           compact=self.compact, vec_dtype=self.vec_dtype,
                           device=self.server.device)
        if self.visited_adaptive:
            self._hop_log.append(np.asarray(res.hops))
            self._hop_log = self._hop_log[-16:]  # bounded rolling window
        ids = np.asarray(res.ids)
        mapped = np.where(ids >= 0,
                          self._snap.ids_map[np.clip(ids, 0, None)], -1)
        t_done = time.monotonic()
        B = len(ids)
        self._stats.submitted += B
        self._stats.admitted += B
        for _ in range(B):  # one synchronous wave = B identical latencies
            self._stats.note_reply(t_done, t_done - t_arrival, False)
        return mapped, np.asarray(res.dists)
