"""Grow-only vector/attribute arena + batched distance evaluation.

The paper's cost model counts *distance computations* (DC) and *filter
checks* — `SearchStats` instruments both exactly.  Distances are evaluated in
per-hop batches (numpy BLAS on host; the device serving path uses the CUDA
kernel in ``repro_torch.kernels``) — batching does not change which vertices are
evaluated (the per-hop ``c_n`` cap and layer priority of Alg. 2 are applied
before evaluation), so DC counts match the paper's sequential formulation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

METRICS = ("l2", "cosine", "ip")

# storage modes for the device-resident vector slab: f32 is exact (and the
# parity oracle), bf16 halves slab bytes, int8 quarters them with per-row
# f32 scales (train/compress.py discipline: scale = max|row|/127)
VEC_DTYPES = ("f32", "int8", "bf16")

_QUANT_EPS = 1e-12


def vec_np_dtype(vec_dtype: str):
    """numpy dtype of the stored slab for a ``vec_dtype`` mode.  numpy has
    no bfloat16, so a bf16 slab is held as its uint16 bit pattern (the
    layout checkpoints store it in); ``torch.from_numpy(slab.view(np.int16))
    .view(torch.bfloat16)`` reads it back as bf16."""
    if vec_dtype == "f32":
        return np.float32
    if vec_dtype == "bf16":
        return np.uint16
    if vec_dtype == "int8":
        return np.int8
    raise ValueError(f"vec_dtype must be one of {VEC_DTYPES}, got {vec_dtype!r}")


def quantize_rows(vectors: np.ndarray, vec_dtype: str):
    """Quantize f32 rows for storage mode ``vec_dtype``.

    Returns ``(slab, scales)`` — ``scales`` is f32 per-row for int8 and
    ``None`` otherwise; a bf16 slab comes back as its uint16 bit pattern
    (see ``vec_np_dtype``).  Quantization is strictly per-row, so quantizing a
    subset of rows (an arena delta scatter) is bitwise identical to slicing
    a full-slab quantization: device/sharded incremental builds stay exactly
    reproducible at any batch split or shard count.
    """
    vec_np_dtype(vec_dtype)  # validates the mode
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    if vec_dtype == "f32":
        return v, None
    if vec_dtype == "bf16":
        # round to nearest even, as ml_dtypes does; kept as uint16 bits
        bf = torch.from_numpy(v).to(torch.bfloat16)
        return bf.view(torch.int16).numpy().view(np.uint16), None
    amax = np.abs(v).max(axis=1) if v.size else np.zeros(v.shape[0], np.float32)
    scales = (np.maximum(amax, _QUANT_EPS) / np.float32(127.0)).astype(np.float32)
    slab = np.clip(np.rint(v / scales[:, None]), -127, 127).astype(np.int8)
    return slab, scales


@dataclass
class SearchStats:
    """Per-query instrumentation (paper's DC / filter-check accounting)."""

    dc: int = 0  # distance computations
    filter_checks: int = 0  # attribute range tests
    hops: int = 0  # beam-search expansions
    lowest_layer: int = 0  # deepest layer touched (Fig. 6 footprints)

    def merge(self, other: "SearchStats") -> None:
        self.dc += other.dc
        self.filter_checks += other.filter_checks
        self.hops += other.hops


@dataclass
class BuildStats:
    dc: int = 0
    searches: int = 0  # SearchCandidates invocations
    searches_skipped: int = 0  # layers served purely by candidate reuse (Thm 3.1)
    prunes: int = 0  # two-stage prune triggers


class VectorStore:
    """Vectors (float32) + attributes (float64) with amortised appends.

    All distance state is explicit float32: vectors, cached squared norms and
    every ``dist_*`` result — the same dtype the device snapshot serves — so
    host/device parity comparisons never silently widen to float64.
    Attributes stay float64 (they are order keys, not distances), but are
    canonicalized to exactly-f32-representable values at the ingest boundary
    so f32 consumers (device slabs, checkpoint sections, range filters)
    agree bitwise with the host order keys.
    """

    __slots__ = (
        "dim", "metric", "vectors", "attrs", "attrs_list", "sq_norms", "n", "_cap",
    )

    def __init__(self, dim: int, metric: str = "l2", capacity: int = 1024):
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
        self.dim = int(dim)
        self.metric = metric
        self._cap = max(int(capacity), 8)
        self.vectors = np.zeros((self._cap, dim), dtype=np.float32)
        self.attrs = np.zeros(self._cap, dtype=np.float64)
        # python-list mirror of attrs for the scalar-indexed search hot loop
        self.attrs_list: list[float] = []
        # cached squared norms for the factorised distance form (f32, matching
        # Snapshot.sq_norms bit for bit)
        self.sq_norms = np.zeros(self._cap, dtype=np.float32)
        self.n = 0

    def __len__(self) -> int:
        return self.n

    @property
    def capacity(self) -> int:
        """Current arena capacity (rows allocated, >= n).  Consumers that
        mirror the arena device-side (the device build arena)
        size their buffers to this so appends between reallocations are pure
        row scatters."""
        return self._cap

    def _grow(self, need: int) -> None:
        new_cap = self._cap
        while new_cap < need:
            new_cap *= 2
        vec = np.zeros((new_cap, self.dim), dtype=np.float32)
        vec[: self.n] = self.vectors[: self.n]
        self.vectors = vec
        att = np.zeros(new_cap, dtype=np.float64)
        att[: self.n] = self.attrs[: self.n]
        self.attrs = att
        nrm = np.zeros(new_cap, dtype=np.float32)
        nrm[: self.n] = self.sq_norms[: self.n]
        self.sq_norms = nrm
        self._cap = new_cap

    def prepare(self, vec: np.ndarray) -> np.ndarray:
        v = np.asarray(vec, dtype=np.float32).reshape(self.dim)
        if self.metric == "cosine":
            nrm = float(np.linalg.norm(v))
            if nrm > 0:
                v = v / nrm
        return v

    def append(self, vec: np.ndarray, attr: float) -> int:
        if self.n + 1 > self._cap:
            self._grow(self.n + 1)
        i = self.n
        v = self.prepare(vec)
        self.vectors[i] = v
        # attributes are canonicalized to exactly-f32-representable values at
        # the ingest boundary: every downstream consumer (device attrs slab,
        # checkpoint dead_vals section, serving range filters) is f32, and a
        # value that differs under f64<->f32 round-trip would silently break
        # dead-value equality after recovery
        attr = float(np.float32(attr))
        self.attrs[i] = attr
        self.attrs_list.append(attr)
        self.sq_norms[i] = np.float32(np.dot(v, v))
        self.n += 1
        return i

    def append_batch(self, vecs: np.ndarray, attrs: np.ndarray) -> np.ndarray:
        """Vectorised append of a micro-batch: one grow, one normalise pass,
        one sq-norm einsum.  Returns the new contiguous vertex ids."""
        vecs = np.asarray(vecs, dtype=np.float32).reshape(-1, self.dim)
        # f32-canonical attrs (see ``append``): round-trip through f32 so the
        # stored f64 order keys are exactly representable in f32
        attrs = (
            np.asarray(attrs, dtype=np.float64)
            .reshape(-1)
            .astype(np.float32)
            .astype(np.float64)
        )
        if len(vecs) != len(attrs):
            raise ValueError(f"{len(vecs)} vectors vs {len(attrs)} attrs")
        b = len(vecs)
        if b == 0:
            return np.empty(0, dtype=np.int64)
        if self.n + b > self._cap:
            self._grow(self.n + b)
        i0 = self.n
        if self.metric == "cosine":
            nrm = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = np.where(nrm > 0, vecs / np.maximum(nrm, 1e-30), vecs)
        self.vectors[i0 : i0 + b] = vecs
        self.attrs[i0 : i0 + b] = attrs
        self.attrs_list.extend(attrs.tolist())
        self.sq_norms[i0 : i0 + b] = np.einsum(
            "ij,ij->i", self.vectors[i0 : i0 + b], self.vectors[i0 : i0 + b]
        )
        self.n += b
        return np.arange(i0, i0 + b, dtype=np.int64)

    # ------------------------------------------------------------- distances
    def dist_batch(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Distances from query ``q`` to rows ``ids`` (exact, f32)."""
        x = self.vectors[ids]
        if self.metric == "l2":
            d = x - q[None, :]
            return np.einsum("ij,ij->i", d, d).astype(np.float32, copy=False)
        # cosine / ip: vectors are pre-normalised for cosine at insert
        return (1.0 - x @ q).astype(np.float32, copy=False)

    def dist_block(self, qs: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Batched-queries distances: ``qs`` [B, d] f32 against per-query id
        rows ``ids`` [B, K] -> f32 [B, K].  One gather + one batched BLAS
        contraction — the host twin of ``repro_torch.kernels.ops.gather_norm_dot`` (same
        factorised ``|v|^2 - 2 v.q + |q|^2`` form, same f32 accumulation)."""
        x = self.vectors[ids]  # [B, K, d]
        dots = np.einsum("bkd,bd->bk", x, qs)
        if self.metric == "l2":
            q2 = np.einsum("bd,bd->b", qs, qs)
            d = self.sq_norms[ids] - 2.0 * dots + q2[:, None]
            np.maximum(d, 0.0, out=d)
            return d.astype(np.float32, copy=False)
        return (1.0 - dots).astype(np.float32, copy=False)

    def dist_pair(self, a: np.ndarray, b: np.ndarray) -> float:
        if self.metric == "l2":
            d = a - b
            return float(d @ d)
        return float(1.0 - a @ b)
