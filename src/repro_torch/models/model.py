"""LM assembly: init / train forward / prefill / decode (the port of
``repro.models.model``) for every arch: attention, RWKV-6 and Mamba
mixers, each with a dense or an MoE FFN.

Parameters live in a ``ParamTree``: an ``nn.Module`` whose parameters
(``requires_grad=False``) mirror the JAX value tree key by key, with the
stacked ``blocks`` of the JAX scan unstacked into a list of layers
(``params["blocks"][i]``, the JAX ``prefix`` layers first).  Weights keep
the JAX layouts (``wq [d, Hq, D]``, ``lm_head [d, V]``, ...), so
``from_jax_params`` copies arrays without a transpose.  The layers run in a
Python loop (the JAX scan exists to keep its compiled program small).

``forward`` returns ``(logits, new_caches)``; the JAX version also returns
the MoE load-balance loss, which reaches a caller with training (``moe.
moe_apply`` returns it).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from . import attention as att
from . import mamba as mam
from . import rwkv as rwk
from .layers import (
    cast, dense, embed_apply, logits_apply, mlp_apply, mlp_init, normal,
    rms_norm,
)
from .moe import moe_apply, moe_init

MIXERS = ("attn", "mamba", "rwkv")


class ParamTree(nn.Module):
    """A tree of tensors (dicts and lists of layers) held as module
    parameters and indexed like the JAX value tree: ``p["attn"]["wq"]``,
    ``p["blocks"][i]``."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            elif isinstance(val, list):
                self.add_module(name, nn.ModuleList(ParamTree(v)
                                                    for v in val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def keys(self) -> tuple:
        return self._keys


def check_supported(cfg: ArchConfig) -> None:
    for i in range(cfg.num_layers):
        if cfg.mixer_kind(i) not in MIXERS:
            raise ValueError(f"unknown mixer kind {cfg.mixer_kind(i)!r}")


# ----------------------------------------------------------------- init
def _block_init(gen, cfg: ArchConfig, layer: int, kw: dict) -> dict:
    d = cfg.d_model
    kind = cfg.mixer_kind(layer)
    p: dict = {"norm1": torch.ones((d,), **kw)}
    if kind == "attn":
        p["attn"] = att.attn_init(gen, cfg, **kw)
    elif kind == "mamba":
        p["mamba"] = mam.mamba_init(gen, cfg, **kw)
    else:
        p["rwkv_tm"] = rwk.rwkv_time_mix_init(gen, cfg, **kw)
    p["norm2"] = torch.ones((d,), **kw)
    if kind == "rwkv":
        p["rwkv_cm"] = rwk.rwkv_channel_mix_init(gen, cfg, **kw)
    elif cfg.is_moe_layer(layer):
        p["moe"] = moe_init(gen, cfg.moe, d, cfg.d_ff, **kw)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, **kw)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> ParamTree:
    """Random weights with the JAX init's distributions (a normal truncated
    to [-2, 2]: 0.02 for the embedding, 1/sqrt(fan_in) for dense weights;
    zeros, ones, -5, 0.3 * normal and the Mamba inits where JAX has them),
    drawn from ``generator`` on ``device`` (``None`` = the card) and
    stored in ``dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)
    kw = dict(device=dev, dtype=dtype)
    tree: dict = {
        "embed": normal((cfg.vocab_size, cfg.d_model), generator, 0.02,
                        **kw),
        "blocks": [_block_init(generator, cfg, i, kw)
                   for i in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.d_model,), **kw),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense((cfg.d_model, cfg.vocab_size), generator,
                                **kw)
    return ParamTree(tree)


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree, dtype=np.float32)
    return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)


def from_jax_params(cfg: ArchConfig, values: dict, device=None,
                    dtype=torch.float32) -> ParamTree:
    """The JAX value tree (``split_tree(init_params(...))[0]``, leaves as
    numpy arrays or anything ``np.asarray`` takes) as the port's
    parameters: the ``prefix`` layers, then every unit of the stacked
    ``blocks`` (leading axis = unit) unstacked into layers in order."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = []
    prefix = values.get("prefix", {})
    for i in range(len(prefix)):
        layers.append(_to_torch(prefix[f"p{i}"], dev, dtype))
    blocks = values["blocks"]
    n_units = np.asarray(blocks["l0"]["norm1"]).shape[0]

    def unit_slice(tree, u):
        if isinstance(tree, dict):
            return {k: unit_slice(v, u) for k, v in tree.items()}
        return np.asarray(tree)[u]

    for u in range(n_units):
        for i in range(cfg.scan_unit):
            layers.append(_to_torch(unit_slice(blocks[f"l{i}"], u), dev,
                                    dtype))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers in the tree, the config "
                         f"has {cfg.num_layers}")
    tree = {k: _to_torch(values[k], dev, dtype)
            for k in ("embed", "final_norm", "lm_head") if k in values}
    tree["blocks"] = layers
    return ParamTree(tree)


def param_count(params: ParamTree) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------- states
def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> list:
    """Decode state: one ``KVCache``, ``MambaState`` or ``RWKVState`` per
    layer."""
    check_supported(cfg)
    dev = resolve_device(device)
    make = {"attn": lambda: att.make_cache(cfg, batch, cache_len, dtype,
                                           device=dev),
            "mamba": lambda: mam.make_mamba_state(cfg, batch, dtype,
                                                  device=dev),
            "rwkv": lambda: rwk.make_rwkv_state(cfg, batch, dtype,
                                                device=dev)}
    return [make[cfg.mixer_kind(i)]() for i in range(cfg.num_layers)]


# --------------------------------------------------------------- forward
def _cast_tree(p, dtype) -> dict:
    """One layer's parameters in the compute type (the JAX scan body casts
    every floating leaf of a unit the same way, ``A_log`` too; no copy
    when they already are)."""
    if isinstance(p, (dict, ParamTree)):
        return {k: _cast_tree(p[k], dtype) for k in p.keys()}
    return cast(p, dtype) if p.is_floating_point() else p


def _block_apply(p, cfg: ArchConfig, i: int, x: torch.Tensor, mode: str,
                 state, pos, cache_len: int, backend: str):
    """One layer. Returns (x, new_state)."""
    kind = cfg.mixer_kind(i)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    new_state = state
    if kind == "attn":
        if mode == "train":
            h = att.attn_train(p["attn"], cfg, h, backend=backend)
        elif mode == "prefill":
            h, new_state = att.attn_prefill(p["attn"], cfg, h, cache_len,
                                            backend=backend)
        else:
            h, new_state = att.attn_decode(p["attn"], cfg, h, state, pos)
    elif kind == "mamba":
        if mode == "decode":
            h, new_state = mam.mamba_decode(p["mamba"], cfg, h, state)
        else:
            h, new_state = mam.mamba_train(
                p["mamba"], cfg, h, state=state if mode == "prefill"
                else None, backend=backend)
    else:
        st = state if mode != "train" else None
        if mode == "prefill" and st is None:
            st = rwk.make_rwkv_state(cfg, x.shape[0], x.dtype,
                                     device=x.device)
        h, carry = rwk.rwkv_time_mix(p["rwkv_tm"], cfg, h, state=st,
                                     backend=backend)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind == "rwkv":
        x_last_in = None if mode == "train" else (
            state.x_ffn if mode == "decode" else torch.zeros_like(x[:, 0]))
        h, x_ffn_last = rwk.rwkv_channel_mix(p["rwkv_cm"], cfg, h,
                                             x_last=x_last_in)
        if mode != "train":
            new_state = rwk.RWKVState(x_att=carry[0], x_ffn=x_ffn_last,
                                      s=carry[1])
    elif "moe" in p:
        h, _ = moe_apply(p["moe"], cfg.moe, h)
    else:
        h = mlp_apply(p["mlp"], h)
    return x + h, new_state


def forward(
    params: ParamTree,
    cfg: ArchConfig,
    inputs: torch.Tensor,
    mode: str = "train",
    caches: list | None = None,
    pos: torch.Tensor | None = None,
    cache_len: int = 0,
    backend: str = "auto",
    compute_dtype=torch.bfloat16,
    last_only: bool = False,
):
    """inputs: tokens [B, T] (int) or embeddings [B, T, d].  Returns
    (logits [B, T, V] in the compute type, new_caches or None).
    ``last_only``: project logits for the final position only.
    ``backend`` reaches the kernels (``kernels.ops`` policy: "auto" = the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    "ref" = the plain versions, with ``wkv6_chunked`` in the RWKV mixer
    and the step scan ``mamba_scan_ref`` in the Mamba mixer).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if inputs.is_floating_point():
        x = inputs.to(compute_dtype)
    else:
        x = embed_apply(params["embed"], inputs, compute_dtype)
    new_caches = [] if caches is not None else None
    for i, blk in enumerate(params["blocks"]):
        st = caches[i] if caches is not None else None
        x, nst = _block_apply(_cast_tree(blk, compute_dtype), cfg, i, x,
                              mode, st, pos, cache_len, backend)
        if caches is not None:
            new_caches.append(nst)
    if last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = logits_apply(params["embed"], x, transpose=True)
    else:
        logits = logits_apply(params["lm_head"], x, transpose=False)
    return logits, new_caches
