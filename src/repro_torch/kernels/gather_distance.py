"""CUDA kernel wrapper: fused candidate gather + distance terms.

The Hopper counterpart of the Pallas kernel in
``repro.kernels.gather_distance``: the candidate rows the beam search
selected are gathered, dequantized (bf16 upcast, int8 times its per-row
scale), dotted with the query and squared-normed in one kernel, so no
[B, K, D] candidate tensor is ever written and only the stored bytes leave
device memory.  The source and its design note are in
``repro_torch/csrc/gather_norm_dot.cu``; the plain version is
``repro_torch.kernels.ref.gather_norm_dot_ref``.

The wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, launches on the current stream and raises if the
launch was refused.  ``LAUNCHES`` counts the launches, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"gather_norm_dot": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def gather_norm_dot(
    table: torch.Tensor,  # {f32|bf16|int8}[n, D] on the card
    ids: torch.Tensor,  # int64[B, K] candidate row ids (clipped in-kernel)
    queries: torch.Tensor,  # f32[B, D]
    scales: torch.Tensor | None = None,  # f32[n] per-row scales (int8 only)
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (dots, v2), both f32[B, K]: ``dots[b,k] = <deq(table[id]), q[b]>``
    and ``v2[b,k] = |deq(table[id])|^2`` with ``id = clip(ids[b,k], 0,
    n-1)``."""
    if not table.is_cuda:
        raise ValueError("gather_norm_dot kernel needs CUDA tensors; use "
                         "repro_torch.kernels.ops for device dispatch")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype {table.dtype} not in f32/bf16/int8")
    if table.dim() != 2 or queries.dim() != 2 or ids.dim() != 2:
        raise ValueError("expected table [n, D], ids [B, K], queries [B, D]")
    n, D = table.shape
    B, K = ids.shape
    if queries.shape != (B, D):
        raise ValueError(f"queries {tuple(queries.shape)} != ({B}, {D})")
    if ids.dtype != torch.int64 or queries.dtype != torch.float32:
        raise TypeError("ids must be int64 and queries float32")
    quantized = table.dtype == torch.int8
    if quantized and scales is None:
        raise ValueError("int8 table requires per-row scales")
    if quantized and (scales.dtype != torch.float32
                      or scales.shape != (n,)):
        raise ValueError("scales must be float32 [n]")
    tensors = [table, ids, queries] + ([scales] if quantized else [])
    for t in tensors:
        if t.device != table.device:
            raise ValueError("all tensors must be on the table's device")
        if not t.is_contiguous():
            raise ValueError("gather_norm_dot takes contiguous tensors")
    dots = torch.empty((B, K), dtype=torch.float32, device=table.device)
    v2 = torch.empty((B, K), dtype=torch.float32, device=table.device)
    if B * K == 0 or n == 0:
        return dots, v2
    fn = _build.load("gather_norm_dot").gather_norm_dot
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), _DTYPE_CODE[table.dtype],
                 scales.data_ptr() if quantized else None,
                 ids.data_ptr(), queries.data_ptr(),
                 dots.data_ptr(), v2.data_ptr(), B, K, D, n, stream)
    if err != 0:
        raise RuntimeError(f"gather_norm_dot launch failed: cudaError {err}")
    LAUNCHES["gather_norm_dot"] += 1
    return dots, v2


def gather_dot(
    table: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[b, k] = <deq(table[ids[b, k]]), queries[b]> (the same kernel,
    dots only)."""
    dots, _ = gather_norm_dot(table, ids, queries, scales=scales)
    return dots
