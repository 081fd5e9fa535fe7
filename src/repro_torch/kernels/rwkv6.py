"""CUDA kernel wrapper: the RWKV-6 (Finch) WKV recurrence.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.rwkv6``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

over r/k/v [B, H, T, N] (f32 or bf16), w [B, H, T, N] f32, u [H, N] f32
and an optional initial state [B, H, N, N] f32; it returns y in r's type
and the final state in f32.  The kernel runs the exact step recurrence
for any T (the Pallas kernel asserts ``T % chunk == 0``).  The source and
its design note are in ``repro_torch/csrc/wkv6.cu``; the plain versions
are ``repro_torch.kernels.ref.wkv6_ref`` (the same steps) and
``wkv6_chunked`` (the chunked closed form).

The wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, launches on the current stream and raises if the
launch was refused.  ``LAUNCHES`` counts the launches it makes.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"wkv6": 0}
MAX_N = 128  # a block holds its head's N x N state in registers

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def wkv6(
    r: torch.Tensor,  # [B, H, T, N] on the card
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # f32, decay in (0, 1)
    u: torch.Tensor,  # f32 [H, N]
    state: torch.Tensor | None = None,  # f32 [B, H, N, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y [B, H, T, N] in r's type, final state f32 [B, H, N, N])."""
    if not r.is_cuda:
        raise ValueError("wkv6 kernel needs CUDA tensors; use "
                         "repro_torch.kernels.ops for device dispatch")
    if r.dim() != 4:
        raise ValueError("expected r/k/v/w [B, H, T, N]")
    B, H, T, N = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if u.shape != (H, N):
        raise ValueError(f"u {tuple(u.shape)} != ({H}, {N})")
    if state is not None and state.shape != (B, H, N, N):
        raise ValueError(f"state {tuple(state.shape)} != ({B}, {H}, {N}, {N})")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("r, k, v must all be float32 or all bfloat16")
    f32 = [w, u] + ([state] if state is not None else [])
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("w, u and the state must be float32")
    if N > MAX_N:
        raise ValueError(f"wkv6 takes N <= {MAX_N}, got {N}")
    for t in [r, k, v] + f32:
        if t.device != r.device:
            raise ValueError("all tensors must be on r's device")
        if not t.is_contiguous():
            raise ValueError("wkv6 takes contiguous tensors")
    y = torch.empty_like(r)
    s_out = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if B * H * N == 0:
        return y, s_out
    fn = _build.load("wkv6").wkv6
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state is None else state.data_ptr(),
                 y.data_ptr(), s_out.data_ptr(), B, H, T, N,
                 _DTYPE_CODE[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["wkv6"] += 1
    return y, s_out
