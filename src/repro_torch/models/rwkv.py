"""RWKV-6 ("Finch") block: data-dependent-decay time mix + channel mix (the
port of ``repro.models.rwkv``).

Attention-free: the time-mix state is a per-head [N, N] matrix.  Prefill
and training run the WKV recurrence through ``kernels.ops.wkv6`` (the CUDA
kernel on the card), or through the chunked closed form ``wkv6_chunked``
when ``backend="ref"``, as the JAX model does; decode is the exact
single-step recurrence in plain torch.

Token-shift mixes use the paper's ddlerp (low-rank data-dependent
interpolation with the previous token); the decay ``w`` is per-channel and
data-dependent through its own LoRA: w = exp(-exp(w0 + tanh(x A_w) B_w)).

With ``tp`` (a ``parallel.tensor_parallel.ModelSplit`` scoped to the
layer's ``rwkv_tm`` or ``rwkv_cm``) and ``heads_x_dim`` split over
``model``, the time mix projects a rank's channels of r, k, v and g
(column-parallel ``wr``/``wk``/``wv``/``wg``), and, when the heads divide
``model``, runs the WKV recurrence, ``u`` and the group norm per local
head (the whole-leaf decay, ``ln_scale`` and ``ln_bias`` read at its
channels); else it all-gathers r, k, v and g and runs the heads whole.
``wo`` is ``[d, d]`` with axes ``("embed", "heads_x_dim")``: its output
dimension is split and its contraction is not, so the rank's gated
output is all-gathered over ``model`` first and its product with the
rank's columns of ``wo`` is all-gathered for the residual.  The channel
mix runs ``wk`` column-parallel into row-parallel ``wv``; ``wr``
(``embed_out``) is whole.  A prefill or decode state stays whole over
``model`` (``parallel.cache_sharding``): a rank reads its heads of it and
the new state is all-gathered.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops, ref
from .layers import dense, rp_matmul, split_on
from .tuning import TUNING

_MIX = ("w", "k", "v", "r", "g")


class RWKVState(NamedTuple):
    x_att: torch.Tensor  # [B, d] last token into time-mix
    x_ffn: torch.Tensor  # [B, d] last token into channel-mix
    s: torch.Tensor  # [B, H, N, N] wkv state, f32


def _dims(cfg: ArchConfig):
    rc = cfg.rwkv
    N = rc.head_dim
    return rc, cfg.d_model // N, N


def rwkv_time_mix_init(gen: torch.Generator, cfg: ArchConfig, *,
                       device=None, dtype=torch.float32) -> dict:
    rc, H, N = _dims(cfg)
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    u = torch.randn((H, N), generator=gen, device=device) * 0.3
    p: dict = {
        "mu_x": torch.zeros((d,), **kw),
        "w0": torch.full((d,), -5.0, **kw),
        "u": u.to(dtype),
        "ln_scale": torch.ones((d,), **kw),
        "ln_bias": torch.zeros((d,), **kw),
    }
    for nm in _MIX:
        p[f"mu_{nm}"] = torch.zeros((d,), **kw)
        p[f"lora_a_{nm}"] = dense((d, rc.mix_lora), gen, **kw)
        p[f"lora_b_{nm}"] = torch.zeros((rc.mix_lora, d), **kw)
    p["decay_a"] = dense((d, rc.decay_lora), gen, **kw)
    p["decay_b"] = torch.zeros((rc.decay_lora, d), **kw)
    for nm in ("r", "k", "v", "g", "o"):
        p[f"w{nm}"] = dense((d, d), gen, **kw)
    return p


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor) -> dict:
    """Data-dependent token-shift interpolations for w, k, v, r, g."""
    delta = x_prev - x
    xx = x + delta * p["mu_x"]
    return {nm: x + delta * (p[f"mu_{nm}"] + torch.tanh(
        xx @ p[f"lora_a_{nm}"]) @ p[f"lora_b_{nm}"]) for nm in _MIX}


def _heads(a: torch.Tensor, H: int, N: int) -> torch.Tensor:
    """[B, T, d] -> [B, H, T, N] (a view)."""
    B, T, _ = a.shape
    return a.reshape(B, T, H, N).transpose(1, 2)


def _group_norm(y: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head LayerNorm of the wkv output (no affine; y [B, T, H, N])."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps)


def _shifted(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """The previous token of every position: ``last`` (or zeros) first."""
    pad = (last[:, None, :].to(x.dtype) if last is not None
           else torch.zeros_like(x[:, :1]))
    return torch.cat([pad, x[:, :-1]], dim=1)


def rwkv_time_mix(p, cfg: ArchConfig, x: torch.Tensor,
                  state: RWKVState | None = None, backend: str = "auto",
                  tp=None):
    """-> (y [B, T, d], (last x, new wkv state) or None without a state).
    ``tp``: the heads x dim split over ``model`` (module docstring)."""
    rc, H, N = _dims(cfg)
    B, T, d = x.shape
    step = state is not None and T == 1
    x_prev = (state.x_att[:, None, :].to(x.dtype) if step
              else _shifted(x, None if state is None else state.x_att))
    mixes = _ddlerp(p, x, x_prev)
    tp = split_on(tp, "wr")
    heads = tp is not None and tp.dim("u") is not None  # whole heads a rank
    if tp is not None:  # column-parallel: their gradients are partial
        mixes.update({nm: tp.copy(mixes[nm]) for nm in "rkvg"})
    r, k, v = (mixes[nm] @ p[f"w{nm}"] for nm in "rkv")
    g = F.silu(mixes["g"] @ p["wg"])
    decay = p["w0"].float() + (
        torch.tanh(mixes["w"] @ p["decay_a"]) @ p["decay_b"]).float()
    w = torch.exp(-torch.exp(decay))  # (0, 1), f32
    ln_scale, ln_bias = p["ln_scale"], p["ln_bias"]
    s0 = state.s if state is not None else None
    if heads:  # this rank's heads of the whole leaves and state
        lo, hi = tp.range(r.shape[-1])
        w = tp.copy(w)[..., lo:hi]
        ln_scale, ln_bias = (tp.copy(t)[lo:hi] for t in (ln_scale, ln_bias))
        if s0 is not None:
            s0 = s0[:, lo // N:hi // N]
    elif tp is not None:  # heads straddle the ranks: every rank runs all
        r, k, v, g = (tp.gather(t, -1) for t in (r, k, v, g))
    Hr = r.shape[-1] // N
    r, k, v, w = (_heads(t, Hr, N) for t in (r, k, v, w))

    if step:  # exact single-step recurrence for decode
        rf, kf, vf = (a.float() for a in (r, k, v))
        kv = kf[..., 0, :, None] * vf[..., 0, None, :]  # [B, H, N, N]
        u = p["u"].float()
        y = torch.einsum("bhn,bhnm->bhm", rf[..., 0, :],
                         s0 + u[None, :, :, None] * kv)[:, :, None, :]
        s_new = w[..., 0, :, None].float() * s0 + kv
    elif backend == "ref":
        y, s_new = ref.wkv6_chunked(r, k, v, w, p["u"], state=s0,
                                    chunk=TUNING.rwkv_chunk or rc.chunk)
    else:
        y, s_new = ops.wkv6(r, k, v, w, p["u"], state=s0, backend=backend)
    y = y.to(x.dtype).transpose(1, 2)  # [B, T, H, N]
    y = _group_norm(y, cfg.norm_eps).reshape(B, T, Hr * N)
    y = y * ln_scale + ln_bias
    y = y * g
    if tp is not None:  # wo's contraction is whole, its output split
        y = tp.gather(y, -1, partial=True) if heads else tp.copy(y)
    y = y @ p["wo"]
    if tp is not None:
        y = tp.gather(y, -1)
        if heads and state is not None:  # the state stays whole
            s_new = tp.all_gather(s_new, 1)
    carry = (x[:, -1, :], s_new) if state is not None else None
    return y, carry


def rwkv_channel_mix_init(gen: torch.Generator, cfg: ArchConfig, *,
                          device=None, dtype=torch.float32) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    return {
        "mu_k": torch.zeros((d,), **kw),
        "mu_r": torch.zeros((d,), **kw),
        "wk": dense((d, ff), gen, **kw),
        "wv": dense((ff, d), gen, **kw),
        "wr": dense((d, d), gen, **kw),
    }


def rwkv_channel_mix(p, cfg: ArchConfig, x: torch.Tensor,
                     x_last: torch.Tensor | None = None, tp=None):
    """-> (y [B, T, d], last x or None without ``x_last``).  ``tp``:
    column-parallel ``wk`` into row-parallel ``wv`` when ``mlp`` splits."""
    T = x.shape[1]
    x_prev = (x_last[:, None, :].to(x.dtype) if x_last is not None and T == 1
              else _shifted(x, x_last))
    delta = x_prev - x
    xk = x + delta * p["mu_k"]
    xr = x + delta * p["mu_r"]
    tp = split_on(tp, "wk")
    if tp is not None:
        xk = tp.copy(xk)
    k = torch.square(torch.relu(xk @ p["wk"]))
    y = torch.sigmoid(xr @ p["wr"]) * rp_matmul(k, p["wv"], tp)
    return y, (x[:, -1, :] if x_last is not None else None)


def make_rwkv_state(cfg: ArchConfig, batch: int, dtype, *,
                    device=None) -> RWKVState:
    _, H, N = _dims(cfg)
    return RWKVState(
        x_att=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        x_ffn=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        s=torch.zeros((batch, H, N, N), dtype=torch.float32, device=device),
    )
