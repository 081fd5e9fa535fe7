"""LM serving: the prefill/decode loop of ``repro.serve.engine.LMServer`` on
torch.

``LMServer`` wraps an arch's prefill and decode steps with a KV/RWKV state
and greedy or temperature sampling, and pools the final-token distribution
into a retrieval embedding.  Unlike the JAX server, which calls ``forward``
with its ``backend="ref"`` default, it passes its ``backend`` through, so
on the card a served model runs the flash-attention and WKV kernels.

``RagPipeline`` (retrieval over a WoW index) waits for the port's
``ServeEngine`` (ROADMAP A3).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..models.model import ParamTree, forward, init_cache


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
        logits, caches = forward(
            self.params, self.cfg, tokens, mode="prefill", caches=caches,
            cache_len=self.max_len, backend=self.backend,
            compute_dtype=self.dtype, last_only=True)
        return logits[:, -1], caches

    @torch.inference_mode()
    def _decode(self, tok: torch.Tensor, pos: torch.Tensor, caches: list):
        logits, caches = forward(
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
        logits, _ = forward(self.params, self.cfg, toks, mode="train",
                            backend=self.backend, compute_dtype=self.dtype,
                            last_only=True)
        probs = torch.softmax(logits[:, -1].float(), dim=-1)
        emb = probs @ self.params["embed"].float()
        return emb.cpu().numpy().astype(np.float32)
