"""Dispatch wrappers: the CUDA kernel for CUDA tensors, the plain torch
version for CPU tensors.

Policy (``backend=``):
  * ``"auto"`` — by tensor device: a CUDA tensor gets the kernel, a CPU
    tensor the plain version;
  * ``"cuda"`` — force the kernel; a CPU tensor raises;
  * ``"ref"`` — force the plain version (any device).

On a CUDA tensor the wrapper launches the kernel or raises; nothing falls
back to the plain version.
"""
from __future__ import annotations

import torch

from . import ref as _ref

BACKENDS = ("auto", "cuda", "ref")


def _use_kernel(backend: str, t: torch.Tensor) -> bool:
    if backend == "ref":
        return False
    if backend == "auto":
        return t.is_cuda
    if backend == "cuda":
        if not t.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f"{t.device}")
        return True
    raise ValueError(f"unknown backend {backend!r}; registered: {BACKENDS}")


def gather_dot(table, ids, queries, backend: str = "auto"):
    if _use_kernel(backend, table):
        from .gather_distance import gather_dot as kern

        return kern(table, ids.long(), queries.float())
    return _ref.gather_dot_ref(table, ids, queries)


def gather_norm_dot(table, ids, queries, scales=None, backend: str = "auto"):
    """Fused candidate gather -> (dots, sq-norms); the serving hot path.

    ``table`` may be f32, bf16, or int8 (``scales`` = per-row f32 scales,
    required for int8); dequant happens inside the kernel / the plain
    gather — callers never dequantize the slab themselves."""
    if _use_kernel(backend, table):
        from .gather_distance import gather_norm_dot as kern

        return kern(table, ids, queries, scales=scales)
    return _ref.gather_norm_dot_ref(table, ids, queries, scales=scales)


def merge_src_indices(pos_a, pos_b, W: int, K: int, method: str = "auto"):
    """Source-index writeback of the counting merge (``_merge_sorted``).

    Given the merged output position of every result entry (``pos_a``
    [B, W]) and new entry (``pos_b`` [B, K]) — a bijection onto
    0..W+K-1 with slots >= W dropped — produce ``src`` [B, W] int64 where
    ``src[b, p]`` is the concatenated-source index (0..W-1 = result row,
    W..W+K-1 = new row) that lands at output slot ``p``.

      * ``"scatter"`` — one scatter of source indices over the full
        W+K positions, then the first W slots;
      * ``"onehot"`` — position-equality one-hots contracted against the
        source-index iota (exact: one hit per output column, indices far
        below 2^24);
      * ``"sort"`` — invert the position permutation with one packed
        single-key sort: ``pos * (W+K) + src`` sorts into output order, and
        the low digits of the first W keys ARE the source indices;
      * ``"auto"`` — ``"sort"`` on every device.
    """
    if method == "auto":
        method = "sort"
    B = pos_a.shape[0]
    WK = W + K
    dev = pos_a.device
    if method == "sort":
        pos = torch.cat([pos_a, pos_b], dim=1).long()
        key = pos * WK + torch.arange(WK, device=dev)[None, :]
        key = torch.sort(key, dim=1, stable=True).values[:, :W]
        return key % WK
    if method == "scatter":
        pos = torch.cat([pos_a, pos_b], dim=1).long()
        src = torch.empty((B, WK), dtype=torch.int64, device=dev)
        src.scatter_(1, pos, torch.arange(WK, device=dev).expand(B, WK))
        return src[:, :W]
    if method == "onehot":
        out = torch.arange(W, device=dev)[None, None, :]
        oa = (pos_a[:, :, None] == out).float()  # [B, W, W]
        ob = (pos_b[:, :, None] == out).float()  # [B, K, W]
        srcf = torch.einsum("bsw,s->bw", oa,
                            torch.arange(W, dtype=torch.float32, device=dev))
        srcf = srcf + torch.einsum(
            "bkw,k->bw", ob,
            W + torch.arange(K, dtype=torch.float32, device=dev))
        return srcf.long()
    raise ValueError(f"unknown writeback method {method!r}")
