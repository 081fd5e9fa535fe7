"""repro_torch — the WoW (window-to-window RFANNS) system on PyTorch and CUDA.

A port of the JAX/Pallas package ``repro`` with the same module layout:
``core/`` holds the host index (numpy) and the device serving hop loop
(torch), ``kernels/`` the hand-written CUDA kernels with their plain torch
twins, ``launch/`` the entry points.  Nothing here imports ``jax`` or
``repro``.

Entry points take ``device=None``, which means ``torch.device("cuda")``;
they raise when CUDA is absent instead of moving to the CPU.  Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; an explicit device is taken as given.
    Raises when a CUDA device is asked for and CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
