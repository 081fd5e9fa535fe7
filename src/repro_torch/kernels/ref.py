"""Plain torch versions of the kernels (the allclose targets in tests and in
``chip_smoke.py``).  Each mirrors its jnp twin in ``repro.kernels.ref``:
same clipping, same upcast, same per-row scale."""
from __future__ import annotations

import torch


def gather_dot_ref(
    table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """out[b, k] = <table[ids[b, k]], queries[b]>  (fused gather + dot).

    Index semantics of a jnp gather: negative ids wrap once, ids past the
    end clamp to the last row."""
    n = table.shape[0]
    ids = ids.long()
    idc = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return torch.einsum("bkd,bd->bk", table[idc].float(), queries.float())


def gather_norm_dot_ref(
    table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (<deq(table[ids[b,k]]), queries[b]>, |deq(table[ids[b,k]])|^2).

    Dequantizing twin of the CUDA kernel: bf16 tables upcast, int8 tables
    multiply the gathered rows by their per-row f32 ``scales`` — the same
    math the kernel does in registers, expressed over a materialized
    gather."""
    n = table.shape[0]
    idc = ids.long().clamp(0, n - 1)
    vecs = table[idc].float()
    if scales is not None:
        vecs = vecs * scales.float()[idc][..., None]
    queries = queries.float()
    return (
        torch.einsum("bkd,bd->bk", vecs, queries),
        torch.einsum("bkd,bkd->bk", vecs, vecs),
    )
