"""Mamba-1 selective SSM mixer, Jamba's dominant layer (the port of
``repro.models.mamba``).

    h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t
    y_t = C_t . h_t + D * x_t              (per channel, diagonal A)

Prefill and training run the scan through ``kernels.ops.mamba_scan`` (the
CUDA kernel on the card), or through the plain step scan
``kernels.ref.mamba_scan_ref`` when ``backend="ref"``, as the JAX model's
``"ref"`` branch runs its jnp ``_ssm_scan``; decode is the exact single
step in plain torch.  The dtypes follow the JAX mixer: dt goes to f32
after the softplus, Bm, Cm and the conv output are cast to f32 for the
scan, the state is f32, and y returns to the compute type before the D
skip and the silu(z) gate.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops, ref
from .layers import dense, normal, rp_matmul
from .tuning import TUNING


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, d_conv-1, d_inner] trailing inputs
    h: torch.Tensor  # [B, d_inner, d_state] f32


def _dims(cfg: ArchConfig):
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_inner, dt_rank


def mamba_init(gen: torch.Generator, cfg: ArchConfig, *, device=None,
               dtype=torch.float32) -> dict:
    """The JAX init's distributions: S4D-real ``A_log = log(1..N)``, a dt
    bias that is the inverse softplus of a log-uniform in [1e-3, 1e-1],
    ``conv_w`` 0.1 times a plain normal, ``conv_b`` zeros, ``D`` ones."""
    mc, di, dtr = _dims(cfg)
    d, N = cfg.d_model, mc.d_state
    kw = dict(device=device, dtype=dtype)
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(torch.rand((di,), generator=gen, device=device)
                   * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    conv_w = 0.1 * torch.randn((mc.d_conv, di), generator=gen, device=device)
    return {
        "in_proj": dense((d, 2 * di), gen, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": dense((di, dtr + 2 * N), gen, **kw),
        "dt_proj": normal((dtr, di), gen, dtr ** -0.5, **kw),
        "dt_bias": dt_bias.to(dtype),
        "A_log": torch.log(a).repeat(di, 1).to(dtype),
        "D": torch.ones((di,), **kw),
        "out_proj": dense((di, d), gen, **kw),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (a cross-correlation over a left pad of
    k-1); x [B, T, di], w [k, di]."""
    k, di = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))  # [B, di, T + k - 1]
    out = F.conv1d(xp, w.t()[:, None, :].to(x.dtype), groups=di)
    return out.transpose(1, 2) + b.to(x.dtype)


def _ssm_inputs(p, cfg: ArchConfig, xc: torch.Tensor):
    """The conv output's projections -> (dt f32, Bm, Cm, A)."""
    _, _, dtr = _dims(cfg)
    N = cfg.mamba.d_state
    dt_r, Bm, Cm = torch.split(xc @ p["x_proj"], [dtr, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"])  # [di, N] in the parameters' type
    return dt, Bm, Cm, A


def mamba_train(p, cfg: ArchConfig, x: torch.Tensor,
                state: MambaState | None = None, backend: str = "auto"
                ) -> tuple[torch.Tensor, MambaState | None]:
    """The mixer over a whole sequence x [B, T, d] -> (out [B, T, d], the
    state after it, or None without ``state``)."""
    mc, di, _ = _dims(cfg)
    B, T, _ = x.shape
    xin, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc = F.silu(_conv_causal(xin, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm, A = _ssm_inputs(p, cfg, xc)
    h0 = (state.h if state is not None else
          torch.zeros((B, di, mc.d_state), dtype=torch.float32,
                      device=x.device))
    chunk = TUNING.mamba_chunk or mc.chunk
    args = (A.float(), dt, Bm.float(), Cm.float(), xc.float(), h0)
    if backend == "ref":
        y, hT = ref.mamba_scan_ref(*args, chunk=chunk)
    else:
        y, hT = ops.mamba_scan(*args, backend=backend, chunk=chunk)
    y = (y.to(x.dtype) + p["D"] * xc) * F.silu(z)
    out = rp_matmul(y, p["out_proj"])
    new_state = None
    if state is not None:
        k = mc.d_conv
        conv_tail = (xin[:, -(k - 1):].clone() if T >= k - 1 else
                     torch.cat([state.conv[:, T:], xin], dim=1))
        new_state = MambaState(conv=conv_tail, h=hT)
    return out, new_state


def mamba_decode(p, cfg: ArchConfig, x: torch.Tensor, state: MambaState
                 ) -> tuple[torch.Tensor, MambaState]:
    """One-token step, x [B, 1, d]: the conv over the state's trailing
    inputs and the exact single-step recurrence."""
    xin, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)  # [B, 1, di]
    window = torch.cat([state.conv.to(x.dtype), xin], dim=1)  # [B, k, di]
    xc = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"])
                + p["conv_b"])[:, None, :]
    dt, Bm, Cm, A = _ssm_inputs(p, cfg, xc)
    dt = dt[:, 0]
    a = torch.exp(dt[..., None] * A.float())  # [B, di, N]
    h = a * state.h + (dt * xc[:, 0].float())[..., None] * \
        Bm[:, 0, None, :].float()
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())[:, None, :]
    y = (y.to(x.dtype) + p["D"] * xc) * F.silu(z)
    return rp_matmul(y, p["out_proj"]), MambaState(conv=window[:, 1:], h=h)


def make_mamba_state(cfg: ArchConfig, batch: int, dtype, *,
                     device=None) -> MambaState:
    mc, di, _ = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                      device=device),
    )
