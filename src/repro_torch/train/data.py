"""Deterministic, elastic data pipeline (the port's copy of
``repro.train.data``, numpy only; batches equal the JAX package's element
for element).

Every batch is a pure function of ``(seed, step)`` — no iterator state to
checkpoint or lose.  Host sharding is a pure function of the healthy-host
list, so when a node fails the survivors recompute their shard assignment
for the same step and the *global* sample sequence is unchanged (elastic
resume; see elastic.py for the assignment function and its invariants).

Two sources:
  * ``RandomTokens`` — uniform tokens (shape/throughput testing).
  * ``MarkovTokens`` — a fixed random first-order Markov chain; a trained
    model's loss converges to the chain's conditional entropy, so training
    curves show real learning (examples/train_lm_torch.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"  # "markov" | "random"
    markov_concentration: float = 0.3


class TokenSource:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind == "markov":
            rng = np.random.default_rng(cfg.seed + 7919)
            probs = rng.dirichlet(
                np.full(cfg.vocab_size, cfg.markov_concentration), size=cfg.vocab_size
            )
            self.transition = probs.astype(np.float64)
            self.cum = np.cumsum(self.transition, axis=1)

    def entropy_rate(self) -> float:
        """Conditional entropy of the chain (nats) — the loss floor."""
        if self.cfg.kind != "markov":
            return float(np.log(self.cfg.vocab_size))
        p = self.transition
        # stationary distribution via power iteration
        pi = np.full(p.shape[0], 1.0 / p.shape[0])
        for _ in range(200):
            pi = pi @ p
        h = -np.sum(pi[:, None] * p * np.log(np.maximum(p, 1e-12)))
        return float(h)

    def global_batch(self, step: int) -> np.ndarray:
        """[global_batch, seq_len + 1] tokens for ``step`` (deterministic)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, T = cfg.global_batch, cfg.seq_len + 1
        if cfg.kind == "random":
            return rng.integers(0, cfg.vocab_size, size=(B, T), dtype=np.int64)
        out = np.empty((B, T), dtype=np.int64)
        state = rng.integers(0, cfg.vocab_size, size=B)
        out[:, 0] = state
        u = rng.random(size=(B, T - 1))
        for t in range(1, T):
            state = np.array(
                [np.searchsorted(self.cum[s], x) for s, x in zip(state, u[:, t - 1])]
            )
            np.minimum(state, cfg.vocab_size - 1, out=state)
            out[:, t] = state
        return out

    def host_batch(
        self, step: int, host: int, healthy_hosts: list[int]
    ) -> tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) shard for ``host`` given the healthy-host list."""
        from .elastic import shard_rows

        full = self.global_batch(step)
        rows = shard_rows(self.cfg.global_batch, host, healthy_hosts)
        part = full[rows]
        return part[:, :-1], part[:, 1:]
