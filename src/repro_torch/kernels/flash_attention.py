"""CUDA kernel wrapper: causal GQA attention with an online softmax.

The Hopper counterpart of the Pallas kernel in
``repro.kernels.flash_attention``: attention over q [B, Tq, Hq, D] and
k/v [B, Tk, Hkv, D] (f32 or bf16, the output in q's type), with an
optional sliding window and a ``q_offset`` (the absolute position of q[0]
relative to k[0]), skipping the key tiles that the mask hides from every
row of a query tile.  Unlike the Pallas kernel it takes any Tq and Tk: the
ragged tails are masked in the kernel.  A row with no visible key gives 0
(the plain version gives NaN).  Both types run on the tensor cores
(wgmma, TMA): bf16 with the probabilities rounded to bf16 for the P V
product (``ref.mha_tolerance`` states what that costs); f32 in TF32 with
every operand split into a TF32 high part and the rest, three products
for each f32 one (3xTF32, ~2^-21 relative, within the f32 rule), after a
pre-pass that writes K's and V^T's parts into a workspace this wrapper
allocates.  The source and its design note are in ``repro_torch/csrc/
flash_attention.cu``; the plain version is ``repro_torch.kernels.ref.
mha_ref``.

The wrapper checks what the kernel takes and raises on anything else,
allocates the output (and the f32 workspace), launches on the current
stream and raises if the launch was refused.  ``LAUNCHES`` counts the
launches it makes (one a call; the f32 pre-pass is part of it).
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"flash_attention": 0}
MAX_D = 128  # f32: four 32-column boxes; bf16: two 64-column boxes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(
    q: torch.Tensor,  # [B, Tq, Hq, D] on the card
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, D]
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """-> [B, Tq, Hq, D] in q's type."""
    if not q.is_cuda:
        raise ValueError("flash_attention kernel needs CUDA tensors; use "
                         "repro_torch.kernels.ops for device dispatch")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q [B, Tq, Hq, D], k/v [B, Tk, Hkv, D]")
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Tk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must all be float32 or all bfloat16")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is no multiple of Hkv={Hkv}")
    if D > MAX_D or D % 4:
        raise ValueError(f"flash_attention takes D <= {MAX_D}, D % 4 == 0; "
                         f"got {D}")
    if q.dtype == torch.bfloat16 and D % 8:
        raise ValueError(f"bf16 flash_attention takes D % 8 == 0 (its TMA "
                         f"row strides are 16-byte multiples); got {D}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention takes contiguous, 16-byte "
                             "aligned tensors")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ws = None
    if q.dtype == torch.float32:  # K's and V^T's TF32 parts, hi and lo
        tk8 = (Tk + 7) // 8 * 8
        ws = torch.empty(2 * B * Hkv * D * (Tk + tk8), dtype=torch.float32,
                         device=q.device)
    fn = _build.load("flash_attention").flash_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), B, Tq, Tk, Hq, Hkv,
                 D, _DTYPE_CODE[q.dtype], D ** -0.5, int(causal),
                 window or 0, q_offset, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["flash_attention"] += 1
    return out
