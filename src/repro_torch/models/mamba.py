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

With ``tp`` (a ``parallel.tensor_parallel.ModelSplit`` scoped to the
layer's ``mamba``) and ``inner`` split over ``model``, a rank runs its
range of the inner channels: ``in_proj`` is stored ``[d, 2 di]`` cut
contiguously over ``model`` (on two ranks, rank 0 holds every channel's
``x`` half and rank 1 the ``z`` half), so a rank's product is all-gathered
over ``model`` and each rank takes its channels' ``x`` and ``z`` (the
exchange XLA's resharding makes; the backward reduce-scatters).  The
conv, ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and the scan run per
channel; ``x_proj`` is row-parallel, so dt, B and C are all-reduced
(``layers.reduce_product``); so is ``out_proj``.  A prefill or decode
state stays whole over ``model`` (as ``parallel.cache_sharding`` lays it
out): a rank reads its channels of it and the new state is all-gathered.
Under the residual row split (``tp.rows``) ``x`` is the rank's rows:
they are gathered before ``in_proj`` (``tp.enter``), so the conv and
the scan see every row, and ``out_proj``'s partial sums are
reduce-scattered to the rank's rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops, ref
from .layers import dense, normal, reduce_product, rp_matmul, split_on
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


def _ssm_inputs(p, cfg: ArchConfig, xc: torch.Tensor, tp=None):
    """The conv output's projections -> (dt f32, Bm, Cm, A).  ``tp``: the
    inner channels split; the row-parallel ``x_proj`` product is
    all-reduced, and dt, B and C then feed every rank's channels."""
    _, _, dtr = _dims(cfg)
    N = cfg.mamba.d_state
    if tp is None:
        dbc = xc @ p["x_proj"]
    else:  # every rank's channels read dt, B and C
        dbc = tp.copy(reduce_product(xc, p["x_proj"], tp.reduce))
    dt_r, Bm, Cm = torch.split(dbc, [dtr, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"])  # [di, N] in the parameters' type
    return dt, Bm, Cm, A


def _in_proj(p, x: torch.Tensor, tp=None):
    """``x @ in_proj`` -> (x half, z half) of the channels the rank
    runs: all of them without ``tp``; with ``in_proj`` split over
    ``model`` (``x`` has entered the split, ``_enter``) the rank's
    product is all-gathered and the rank takes its inner channels' x and
    z (every channel when ``inner`` is whole)."""
    proj = split_on(tp, "in_proj")
    if proj is None:
        return torch.chunk(x @ p["in_proj"], 2, dim=-1)
    inner = split_on(tp, "conv_w")
    u = proj.gather(x @ p["in_proj"], -1, partial=inner is not None)
    xin, z = torch.chunk(u, 2, dim=-1)
    if inner is None:
        return xin, z
    lo, hi = inner.range(p["conv_w"].shape[1])
    return xin[..., lo:hi], z[..., lo:hi]


def _enter(tp, x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``in_proj``'s product reads it: entered into the split
    (``ModelSplit.enter``) when ``in_proj`` splits over ``model``."""
    proj = split_on(tp, "in_proj")
    return x if proj is None else proj.enter(x)


def _channels(tp, p, t: torch.Tensor, dim: int) -> torch.Tensor:
    """A whole state's channels (``dim``) that the rank runs."""
    if tp is None:
        return t
    lo, hi = tp.range(p["conv_w"].shape[1])
    return t.narrow(dim, lo, hi - lo)


def mamba_train(p, cfg: ArchConfig, x: torch.Tensor,
                state: MambaState | None = None, backend: str = "auto",
                tp=None) -> tuple[torch.Tensor, MambaState | None]:
    """The mixer over a whole sequence x [B, T, d] -> (out [B, T, d], the
    state after it, or None without ``state``)."""
    mc, di, _ = _dims(cfg)
    x = _enter(tp, x)
    B, T, _ = x.shape
    xin, z = _in_proj(p, x, tp)
    tp = split_on(tp, "conv_w")
    xc = F.silu(_conv_causal(xin, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm, A = _ssm_inputs(p, cfg, xc, tp)
    h0 = (_channels(tp, p, state.h, 1) if state is not None else
          torch.zeros((B, xin.shape[-1], mc.d_state), dtype=torch.float32,
                      device=x.device))
    chunk = TUNING.mamba_chunk or mc.chunk
    args = (A.float(), dt, Bm.float(), Cm.float(), xc.float(), h0)
    if backend == "ref":
        y, hT = ref.mamba_scan_ref(*args, chunk=chunk)
    else:
        y, hT = ops.mamba_scan(*args, backend=backend, chunk=chunk)
    y = (y.to(x.dtype) + p["D"] * xc) * F.silu(z)
    out = rp_matmul(y, p["out_proj"], tp)
    new_state = None
    if state is not None:
        k = mc.d_conv
        conv_tail = (xin[:, -(k - 1):].clone() if T >= k - 1 else
                     torch.cat([_channels(tp, p, state.conv, 2)[:, T:],
                                xin], dim=1))
        if tp is not None:  # the state stays whole over model
            conv_tail, hT = tp.all_gather(conv_tail, 2), tp.all_gather(hT, 1)
        new_state = MambaState(conv=conv_tail, h=hT)
    return out, new_state


def mamba_decode(p, cfg: ArchConfig, x: torch.Tensor, state: MambaState,
                 tp=None) -> tuple[torch.Tensor, MambaState]:
    """One-token step, x [B, 1, d]: the conv over the state's trailing
    inputs and the exact single-step recurrence."""
    x = _enter(tp, x)
    xin, z = _in_proj(p, x, tp)  # [B, 1, di]
    tp = split_on(tp, "conv_w")
    window = torch.cat([_channels(tp, p, state.conv, 2).to(x.dtype), xin],
                       dim=1)  # [B, k, di]
    xc = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"])
                + p["conv_b"])[:, None, :]
    dt, Bm, Cm, A = _ssm_inputs(p, cfg, xc, tp)
    dt = dt[:, 0]
    a = torch.exp(dt[..., None] * A.float())  # [B, di, N]
    h = a * _channels(tp, p, state.h, 1) + (dt * xc[:, 0].float())[
        ..., None] * Bm[:, 0, None, :].float()
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())[:, None, :]
    y = (y.to(x.dtype) + p["D"] * xc) * F.silu(z)
    conv = window[:, 1:]
    out = rp_matmul(y, p["out_proj"], tp)
    if tp is not None:  # the state stays whole over model
        conv, h = tp.all_gather(conv, 2), tp.all_gather(h, 1)
    return out, MambaState(conv=conv, h=h)


def make_mamba_state(cfg: ArchConfig, batch: int, dtype, *,
                     device=None) -> MambaState:
    mc, di, _ = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                      device=device),
    )
