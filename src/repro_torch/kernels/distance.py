"""CUDA kernel wrapper: batched query-candidate dots over gathered rows.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.distance``:
for B queries, each with K already-gathered candidate rows, compute all
B*K inner products ``out[b, k] = <v[b, k, :], q[b, :]>`` — the distance
stage of the reference hop pipeline (``core.hop_reference.
eval_materialized``).  The source and its design note are in
``repro_torch/csrc/batched_dot.cu``; the plain version is
``repro_torch.kernels.ref.batched_dot_ref``.

The wrapper checks what the kernel takes and raises on anything else,
allocates the output, launches on the current stream and raises if the
launch was refused.  ``LAUNCHES`` counts the launches it makes, so a run
can show that its main path went through the kernel; a call under CUDA-graph
capture only records a launch, and the graph's replays go past the wrapper
(``core.device_search.KERNEL_REPLAYS`` counts the launches they run).
``l2_distance`` composes the factorised L2 around the kernel, as the JAX
wrapper does.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"batched_dot": 0}
MAX_D = 12288  # the widths the wrapper takes (the kernel itself takes any)


def batched_dot(
    vecs: torch.Tensor,  # f32[B, K, D] on the card
    queries: torch.Tensor,  # f32[B, D]
) -> torch.Tensor:
    """-> f32[B, K], ``out[b, k] = <vecs[b, k], queries[b]>``."""
    if not vecs.is_cuda:
        raise ValueError("batched_dot kernel needs CUDA tensors; use "
                         "repro_torch.kernels.ops for device dispatch")
    if vecs.dim() != 3 or queries.dim() != 2:
        raise ValueError("expected vecs [B, K, D] and queries [B, D]")
    B, K, D = vecs.shape
    if queries.shape != (B, D):
        raise ValueError(f"queries {tuple(queries.shape)} != ({B}, {D})")
    if vecs.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("batched_dot takes float32 vecs and queries")
    if D > MAX_D:
        raise ValueError(f"batched_dot takes D <= {MAX_D}, got {D}")
    for t in (vecs, queries):
        if t.device != vecs.device:
            raise ValueError("vecs and queries must be on one device")
        if not t.is_contiguous():
            raise ValueError("batched_dot takes contiguous tensors")
    out = torch.empty((B, K), dtype=torch.float32, device=vecs.device)
    if B * K == 0:
        return out
    fn = _build.load("batched_dot").batched_dot
    with torch.cuda.device(vecs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vecs.data_ptr(), queries.data_ptr(), out.data_ptr(),
                 B, K, D, stream)
    if err != 0:
        raise RuntimeError(f"batched_dot launch failed: cudaError {err}")
    if not torch.cuda.is_current_stream_capturing():
        # under CUDA-graph capture the call only records the launch
        LAUNCHES["batched_dot"] += 1
    return out


def l2_distance(
    vecs: torch.Tensor,
    queries: torch.Tensor,
    sq_norms: torch.Tensor,
) -> torch.Tensor:
    """``||vecs[b,k] - queries[b]||^2`` with the kernel-computed cross
    term: ``max(|v|^2 - 2 v.q + |q|^2, 0)``."""
    q2 = (queries * queries).sum(dim=-1)
    dots = batched_dot(vecs, queries)
    return (sq_norms - 2.0 * dots + q2[:, None]).clamp(min=0.0)
