"""CUDA kernel wrapper: the Mamba-1 selective scan.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.mamba_scan``:

    h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t
    y_t = C_t . h_t

over A [di, N], dt/x [B, T, di], Bm/Cm [B, T, N] and the initial state
h0 [B, di, N], all f32; it returns (y [B, T, di], h_T [B, di, N]) in f32.
The kernel keeps each channel's state in registers for the whole sequence
and takes any T and di (the Pallas kernel asserts ``di % 256 == 0``).  The
source and its design note are in ``repro_torch/csrc/mamba_scan.cu``; the
plain version is ``repro_torch.kernels.ref.mamba_scan_ref``.

The wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, launches on the current stream and raises if the
launch was refused.  ``LAUNCHES`` counts the launches it makes.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"mamba_scan": 0}
MAX_N = 64  # a thread keeps h[0..N) and A[d, 0..N) in registers


def mamba_scan(
    A: torch.Tensor,  # [di, N] on the card
    dt: torch.Tensor,  # [B, T, di]
    Bm: torch.Tensor,  # [B, T, N]
    Cm: torch.Tensor,  # [B, T, N]
    x: torch.Tensor,  # [B, T, di]
    h0: torch.Tensor,  # [B, di, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y [B, T, di] f32, h_T [B, di, N] f32)."""
    if not x.is_cuda:
        raise ValueError("mamba_scan kernel needs CUDA tensors; use "
                         "repro_torch.kernels.ops for device dispatch")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("expected A [di, N] and x [B, T, di]")
    B, T, di = x.shape
    N = A.shape[1]
    shapes = (("A", A, (di, N)), ("dt", dt, (B, T, di)),
              ("Bm", Bm, (B, T, N)), ("Cm", Cm, (B, T, N)),
              ("h0", h0, (B, di, N)))
    for name, t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} != {want}")
    if N > MAX_N:
        raise ValueError(f"mamba_scan takes N <= {MAX_N}, got {N}")
    if B > 65535:
        raise ValueError(f"mamba_scan takes B <= 65535, got {B}")
    for t in (A, dt, Bm, Cm, x, h0):
        if t.dtype != torch.float32:
            raise TypeError("mamba_scan takes float32 tensors")
        if t.device != x.device:
            raise ValueError("all tensors must be on x's device")
        if not t.is_contiguous():
            raise ValueError("mamba_scan takes contiguous tensors")
    y = torch.empty_like(x)
    h_T = torch.empty_like(h0)
    if B * di * N == 0:
        return y, h_T
    fn = _build.load("mamba_scan").mamba_scan
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(A.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 x.data_ptr(), h0.data_ptr(), y.data_ptr(), h_T.data_ptr(),
                 B, T, di, N, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {err}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["mamba_scan"] += 1
    return y, h_T
