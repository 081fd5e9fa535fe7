"""Hierarchical window-graph storage: padded per-layer adjacency arenas.

Layer ``l`` is a directed graph whose edges satisfy the window property with
half-window ``o**l`` (Def. 4).  Every vertex exists in every layer; raising
the top layer clones the old top (Alg. 1 lines 2–4), so the new top inherits
a graph whose window already covered the whole dataset.

Adjacency is a dense ``int32[cap, m]`` arena per layer (−1 padded) — the same
memory layout the device-side snapshot uses, making snapshot creation a
copy-free view.
"""
from __future__ import annotations

import numpy as np

PAD = -1


class LayeredGraph:
    __slots__ = ("m", "layers", "counts", "_cap", "version")

    def __init__(self, m: int, capacity: int = 1024):
        self.m = int(m)
        self._cap = max(int(capacity), 8)
        self.layers: list[np.ndarray] = []
        self.counts: list[np.ndarray] = []
        # monotone edge-version stamp: bumped by every structural mutation
        # that goes through the mutator methods.  Consumers that mirror the
        # adjacency (the persistent build slab / device delta arena in
        # ``repro_torch.core.snapshot``) record the stamp at sync time and fall
        # back to a full rebuild when it moved underneath them.  Bulk writers
        # that scatter into ``layers``/``counts`` directly (the batched
        # commit) must bump it manually before recording their deltas.
        self.version = 0
        self.add_layer()

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def top(self) -> int:
        return len(self.layers) - 1

    @property
    def capacity(self) -> int:
        """Arena capacity (rows allocated per layer); mirrors size to the
        persistent build slab / device delta arena."""
        return self._cap

    def add_layer(self, clone_from: int | None = None) -> None:
        if clone_from is not None:
            self.layers.append(self.layers[clone_from].copy())
            self.counts.append(self.counts[clone_from].copy())
        else:
            self.layers.append(np.full((self._cap, self.m), PAD, dtype=np.int32))
            self.counts.append(np.zeros(self._cap, dtype=np.int32))
        self.version += 1

    def ensure_capacity(self, n: int) -> None:
        if n <= self._cap:
            return
        new_cap = self._cap
        while new_cap < n:
            new_cap *= 2
        for i in range(len(self.layers)):
            lay = np.full((new_cap, self.m), PAD, dtype=np.int32)
            lay[: self._cap] = self.layers[i]
            self.layers[i] = lay
            cnt = np.zeros(new_cap, dtype=np.int32)
            cnt[: self._cap] = self.counts[i]
            self.counts[i] = cnt
        self._cap = new_cap
        self.version += 1

    def neighbors(self, l: int, v: int) -> np.ndarray:
        """View of the current out-neighbors of ``v`` at layer ``l``."""
        return self.layers[l][v, : self.counts[l][v]]

    def degree(self, l: int, v: int) -> int:
        return int(self.counts[l][v])

    def set_neighbors(self, l: int, v: int, ids: np.ndarray) -> None:
        k = len(ids)
        assert k <= self.m, f"degree {k} exceeds m={self.m}"
        self.layers[l][v, :k] = ids
        self.layers[l][v, k:] = PAD
        self.counts[l][v] = k
        self.version += 1

    def append_neighbor(self, l: int, v: int, nid: int) -> bool:
        """Append if there is an empty slot; returns False when full."""
        c = int(self.counts[l][v])
        if c >= self.m:
            return False
        self.layers[l][v, c] = nid
        self.counts[l][v] = c + 1
        self.version += 1
        return True

    def out_degree_histogram(self, l: int, n: int) -> np.ndarray:
        return np.bincount(self.counts[l][:n], minlength=self.m + 1)
