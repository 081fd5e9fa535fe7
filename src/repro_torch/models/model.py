"""LM assembly: init / train forward / prefill / decode (the port of
``repro.models.model``) for every arch: attention, RWKV-6 and Mamba
mixers, each with a dense or an MoE FFN.

Parameters live in a ``ParamTree``: an ``nn.Module`` whose parameters
(``requires_grad=False``) mirror the JAX value tree key by key, with the
stacked ``blocks`` of the JAX scan unstacked into a list of layers
(``params["blocks"][i]``, the JAX ``prefix`` layers first).  Weights keep
the JAX layouts (``wq [d, Hq, D]``, ``lm_head [d, V]``, ...), so
``from_jax_params`` copies arrays without a transpose and ``to_jax_values``
restacks them.  The layers run in a Python loop (the JAX scan exists to
keep its compiled program small); in training each JAX scan unit
(``cfg.scan_unit`` consecutive layers) is one rematerialised segment.

Training is a choice at the call site: ``params.requires_grad_(True)``,
then ``loss_fn`` (the trainer in ``repro_torch.train`` does both).
``forward`` returns ``(logits, new_caches, aux)`` as the JAX version does,
``aux`` being the MoE load-balance loss summed over the layers.

``forward``, ``loss_fn`` and ``init_cache`` take ``tp``, a
``parallel.tensor_parallel.ModelSplit``: the parameters are then a rank's
``model`` parts (what the mesh train step's hooks give the forward) and
every layer computes only its part of what the specs split over
``model`` (heads, mlp, experts, Mamba's inner channels, RWKV's heads x
dim; the vocab of the lookup and of the head, whose logits are then the
rank's vocab range and whose loss is the vocab-parallel logsumexp), the
experts on ``data`` that ``tp.experts`` names (``models.moe``), and,
under ``TUNING.attn_seq_axis`` / ``cache_seq_shard``, the attention's
query rows and a decode cache's slots (``models.attention``).  Under
``TUNING.residual_spec`` with ``model`` on the batch or the sequence
(``tuning.residual_dim``), the reference's pin at the entry of every JAX
scan unit, the residual stream is split over ``model`` from the first
unit to the last in every mode: a rank holds its rows (``ModelSplit.
residual``; the lookup's sum lands split when no leading layer runs
first), the norms and residual adds run on them, and under remat a unit
saves the rank's rows only; after the last unit the final norm runs on
them and the rows are gathered for the head (its backward reduce-scatters
the head's partial gradients).  The numbers are the unsplit ones.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from . import attention as att
from . import mamba as mam
from . import rwkv as rwk
from .layers import (
    cast, dense, embed_apply, logits_apply, mlp_apply, mlp_init, normal,
    rms_norm, split_on, sub, whole_rows,
)
from .moe import moe_apply, moe_init
from .tuning import residual_dim

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


def abstract_params(cfg: ArchConfig, dtype=torch.float32) -> ParamTree:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    memory (the counterpart of the JAX ``eval_shape`` tree)."""
    return init_params(cfg, torch.Generator().manual_seed(0),
                       device="meta", dtype=dtype)


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


def _prefix_len(cfg: ArchConfig) -> int:
    """Leading layers outside the JAX scan (deepseek's dense layers)."""
    return cfg.moe.first_k_dense if cfg.moe else 0


def jax_path(cfg: ArchConfig, name: str) -> tuple[tuple, int | None]:
    """A parameter's name in the port (``blocks.3.attn.wq``) -> its key
    path in the JAX value tree and its index on the stacked unit axis
    (None outside the scan): ``(("blocks", "l0", "attn", "wq"), 3)``, or
    ``(("prefix", "p0", ...), None)`` for a leading dense layer."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts), None
    i, pk = int(parts[1]), _prefix_len(cfg)
    if i < pk:
        return ("prefix", f"p{i}", *parts[2:]), None
    u, li = divmod(i - pk, cfg.scan_unit)
    return ("blocks", f"l{li}", *parts[2:]), u


def named_tensors(tree) -> dict:
    """``{name: tensor}`` of a ``ParamTree`` (its parameters) or of a
    mapping keyed by such names (the optimizer's moments)."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def to_jax_values(cfg: ArchConfig, params) -> dict:
    """The inverse of ``from_jax_params``: the JAX value tree of numpy
    arrays, every unit's layers restacked into ``blocks/l{i}`` with the
    unit axis leading and the leading dense layers under ``prefix/p{i}``.
    ``params`` is a ``ParamTree`` or a mapping of its parameter names to
    tensors of the same shapes (the optimizer's moments).  Each tensor is
    copied once, straight into its place in a fresh host array (bf16 as
    f32)."""
    pk = _prefix_len(cfg)
    if (cfg.num_layers - pk) % cfg.scan_unit:
        raise ValueError(f"{cfg.num_layers} layers hold no whole number of "
                         f"{cfg.scan_unit}-layer JAX scan units")
    n_units = (cfg.num_layers - pk) // cfg.scan_unit
    arrays: dict = {}
    for name, t in named_tensors(params).items():
        path, u = jax_path(cfg, name)
        if path not in arrays:
            shape = t.shape if u is None else (n_units, *t.shape)
            arrays[path] = torch.empty(shape, dtype=(
                torch.float32 if t.dtype == torch.bfloat16 else t.dtype))
        (arrays[path] if u is None else arrays[path][u]).copy_(t.detach())
    out: dict = {}
    for path, a in arrays.items():
        _put(out, path, a.numpy())
    return out


def _put(tree: dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


# The JAX package's logical axis names of each parameter (its ``Param``
# axes), keyed by the leaf's name within its module; a layer's leaves are
# stacked on a leading "layers" axis inside the JAX scan.
_HEADS = ("heads", "head_dim")
_KV = ("kv_heads", "head_dim")
_MLP = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
        "wo": ("mlp", "embed")}
_LEAF_AXES = {
    None: {"embed": ("vocab", "embed"), "final_norm": ("embed",),
           "lm_head": ("embed", "vocab"), "norm1": ("embed",),
           "norm2": ("embed",)},
    "attn": {"wq": ("embed", *_HEADS), "wk": ("embed", *_KV),
             "wv": ("embed", *_KV), "wo": (*_HEADS, "embed"),
             "bq": _HEADS, "bk": _KV, "bv": _KV, "q_norm": ("head_dim",),
             "k_norm": ("head_dim",)},
    "mlp": _MLP,
    "shared": _MLP,
    "moe": {"router": ("embed", "expert_unsharded"),
            "wi_gate": ("expert", "embed", "mlp"),
            "wi_up": ("expert", "embed", "mlp"),
            "wo": ("expert", "mlp", "embed")},
    "mamba": {"in_proj": ("embed", "inner"), "conv_w": ("conv", "inner"),
              "conv_b": ("inner",), "x_proj": ("inner", "state_proj"),
              "dt_proj": ("state_proj", "inner"), "dt_bias": ("inner",),
              "A_log": ("inner", "state"), "D": ("inner",),
              "out_proj": ("inner", "embed")},
    "rwkv_tm": {"w0": ("embed",), "u": _HEADS, "ln_scale": ("embed",),
                "ln_bias": ("embed",), "decay_a": ("embed", "lora"),
                "decay_b": ("lora", "embed"),
                **{f"mu_{nm}": ("embed",) for nm in "xwkvrg"},
                **{f"lora_a_{nm}": ("embed", "lora") for nm in "wkvrg"},
                **{f"lora_b_{nm}": ("lora", "embed") for nm in "wkvrg"},
                **{f"w{nm}": ("embed", "heads_x_dim") for nm in "rkvgo"}},
    "rwkv_cm": {"mu_k": ("embed",), "mu_r": ("embed",),
                "wk": ("embed", "mlp"), "wv": ("mlp", "embed"),
                "wr": ("embed", "embed_out")},
}


def param_axes(name: str) -> tuple[str, ...]:
    """The logical axes of the port's parameter ``name`` as the port
    stores it (a layer unstacked): ``blocks.3.attn.wq`` -> ``("embed",
    "heads", "head_dim")``."""
    parts = name.split(".")
    module = parts[-2] if len(parts) > 1 and not parts[-2].isdigit() \
        else None
    return _LEAF_AXES[module][parts[-1]]


def logical_axes(cfg: ArchConfig) -> dict[str, tuple[str, ...]]:
    """``{parameter name: logical axes}`` for every parameter of ``cfg``
    as the JAX ``Param`` carries them: a leaf inside the JAX scan has
    "layers" first (``wq`` of a scanned layer is ``("layers", "embed",
    "heads", "head_dim")``), a leading dense layer's (deepseek's
    ``prefix``) and the top-level leaves do not."""
    out = {}
    for name, _ in abstract_params(cfg).named_parameters():
        axes = param_axes(name)
        out[name] = (("layers", *axes) if jax_path(cfg, name)[1] is not None
                     else axes)
    return out


def tree_from_named(named: dict) -> ParamTree:
    """A ``ParamTree`` of the tensors of ``named`` (``{name: tensor}`` as
    ``named_tensors`` keys them), in its order: ``blocks.<i>.*`` become
    the list of layers."""
    tree: dict = {}
    for name, t in named.items():
        _put(tree, tuple(name.split(".")), t)
    if "blocks" in tree:
        tree["blocks"] = [tree["blocks"][str(i)]
                          for i in range(len(tree["blocks"]))]
    return ParamTree(tree)


def param_count(params: ParamTree) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------- states
def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None, tp=None) -> list:
    """Decode state: one ``KVCache``, ``MambaState`` or ``RWKVState`` per
    layer.  With ``tp`` a KV cache holds the kv heads the rank computes
    (its share when they split over ``model``), and under ``TUNING.
    cache_seq_shard`` the rank's ``1 / n`` of the slots where the kv
    heads stay whole (``attention.cache_split``); the SSM states stay
    whole, as ``parallel.cache_sharding`` lays them out."""
    check_supported(cfg)
    dev = resolve_device(device)

    def kv_cache(i: int):
        at = sub(tp, f"blocks.{i}.attn")
        wk = split_on(at, "wk")
        cs = att.cache_split(cfg, at, cache_len)
        return att.make_cache(
            cfg, batch, cache_len, dtype, device=dev,
            kv_heads=cfg.num_kv_heads // (1 if wk is None else wk.n),
            parts=1 if cs is None else cs.n)

    make = {"attn": kv_cache,
            "mamba": lambda i: mam.make_mamba_state(cfg, batch, dtype,
                                                    device=dev),
            "rwkv": lambda i: rwk.make_rwkv_state(cfg, batch, dtype,
                                                  device=dev)}
    return [make[cfg.mixer_kind(i)](i) for i in range(cfg.num_layers)]


def abstract_cache(cfg: ArchConfig, batch: int, cache_len: int,
                   dtype=torch.bfloat16) -> list:
    """``init_cache`` on the ``meta`` device: shapes and dtypes, no
    memory (the counterpart of the JAX ``eval_shape`` cache)."""
    return init_cache(cfg, batch, cache_len, dtype, device="meta")


# --------------------------------------------------------------- forward
def _cast_tree(p, dtype) -> dict:
    """One layer's parameters in the compute type (the JAX scan body casts
    every floating leaf of a unit the same way, ``A_log`` too; no copy
    when they already are)."""
    if isinstance(p, (dict, ParamTree)):
        return {k: _cast_tree(p[k], dtype) for k in p.keys()}
    return cast(p, dtype) if p.is_floating_point() else p


def _block_apply(p, cfg: ArchConfig, i: int, x: torch.Tensor, mode: str,
                 state, pos, cache_len: int, backend: str, tp=None):
    """One layer (``tp`` scoped to it). Returns (x, new_state, MoE aux
    loss or None).  Under the residual row split (``tp.rows``) ``x`` is
    the rank's rows: the norms and residual adds run on them (a norm's
    scale through ``row_param``), a mixer whose products split over
    ``model`` gathers its input and reduce-scatters its output itself,
    and one that runs whole on every rank (RWKV's, attention with whole
    query heads, Mamba with whole inner channels) runs on the gathered
    rows and hands back the rank's (``layers.whole_rows``)."""
    kind = cfg.mixer_kind(i)
    aux = None
    rows = tp is not None and tp.rows is not None

    def norm(x, scale):
        return rms_norm(x, tp.row_param(scale) if rows else scale,
                        cfg.norm_eps)

    h = norm(x, p["norm1"])
    if kind == "attn":
        def mix(h, t):
            at = sub(t, "attn")
            if mode == "train":
                return att.attn_train(p["attn"], cfg, h, backend=backend,
                                      tp=at), state
            if mode == "prefill":
                return att.attn_prefill(p["attn"], cfg, h, cache_len,
                                        backend=backend, tp=at)
            return att.attn_decode(p["attn"], cfg, h, state, pos, tp=at,
                                   cache_len=cache_len)
        ready = split_on(sub(tp, "attn"), "wq") is not None
    elif kind == "mamba":
        def mix(h, t):
            if mode == "decode":
                return mam.mamba_decode(p["mamba"], cfg, h, state,
                                        tp=sub(t, "mamba"))
            return mam.mamba_train(
                p["mamba"], cfg, h, state=state if mode == "prefill"
                else None, backend=backend, tp=sub(t, "mamba"))
        mt = sub(tp, "mamba")
        ready = None not in (split_on(mt, "in_proj"),
                             split_on(mt, "conv_w"))
    else:
        def mix(h, t):
            st = state if mode != "train" else None
            if mode == "prefill" and st is None:
                st = rwk.make_rwkv_state(cfg, h.shape[0], h.dtype,
                                         device=h.device)
            return rwk.rwkv_time_mix(p["rwkv_tm"], cfg, h, state=st,
                                     backend=backend,
                                     tp=sub(t, "rwkv_tm"))
        ready = False
    h, new_state = mix(h, tp) if ready else whole_rows(tp, mix, h)
    x = x + h
    h = norm(x, p["norm2"])
    if kind == "rwkv":
        carry = new_state

        def channel_mix(h, t):
            x_last_in = None if mode == "train" else (
                state.x_ffn if mode == "decode" else
                torch.zeros_like(h[:, 0]))
            return rwk.rwkv_channel_mix(p["rwkv_cm"], cfg, h,
                                        x_last=x_last_in,
                                        tp=sub(t, "rwkv_cm"))
        h, x_ffn_last = whole_rows(tp, channel_mix, h)
        new_state = state
        if mode != "train":
            new_state = rwk.RWKVState(x_att=carry[0], x_ffn=x_ffn_last,
                                      s=carry[1])
    elif "moe" in p:
        h, aux = moe_apply(p["moe"], cfg.moe, h, tp=sub(tp, "moe"))
    else:
        h = mlp_apply(p["mlp"], h, sub(tp, "mlp"))
    return x + h, new_state, aux


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
    remat: bool = True,
    tp=None,
):
    """inputs: tokens [B, T] (int) or embeddings [B, T, d].  Returns
    (logits [B, T, V] in the compute type, new_caches or None, the MoE
    load-balance loss summed over the layers: f32, 0 without MoE layers).
    ``last_only``: project logits for the final position only.
    ``backend`` reaches the kernels (``kernels.ops`` policy: "auto" = the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    "ref" = the plain versions, with ``wkv6_chunked`` in the RWKV mixer
    and the step scan ``mamba_scan_ref`` in the Mamba mixer).
    ``remat``: when autograd records a train-mode forward, each JAX scan
    unit runs under ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``
    with ``nothing_saveable``): only a unit's input is kept, and its
    layers, the cast of its parameters included, run again in backward.
    ``tp`` (a ``ModelSplit``): ``params`` are the rank's ``model`` parts
    and each layer computes its part (see the module docstring); the
    logits are then the rank's vocab range when the head's vocab splits.
    A ``blocks`` that has ``at(i, dtype)`` (the mesh step's) gives layer
    ``i`` already cast to the compute type.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    pk = _prefix_len(cfg)
    rdim = residual_dim()
    rs = (tp.residual(rdim, inputs.shape[rdim]) if tp is not None and
          tp.n > 1 and rdim is not None else None)
    emb = None
    if inputs.is_floating_point():
        x = inputs.to(compute_dtype)
    else:  # with no leading layer the lookup's sum lands split
        emb = split_on(rs if rs is not None and pk == 0 else tp, "embed")
        x = embed_apply(params["embed"], inputs, compute_dtype, emb)
    blocks = params["blocks"]
    at = getattr(blocks, "at", None)
    new_caches = [] if caches is not None else None

    def span(lo: int, hi: int, x, aux, split):
        for i in range(lo, hi):
            st = caches[i] if caches is not None else None
            p = blocks[i] if at is None else at(i, compute_dtype)
            x, nst, a = _block_apply(_cast_tree(p, compute_dtype),
                                     cfg, i, x, mode, st, pos, cache_len,
                                     backend, sub(split, f"blocks.{i}"))
            if caches is not None:
                new_caches.append(nst)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n = len(blocks)
    x, aux = span(0, pk, x, aux, tp)  # JAX runs these outside its scan
    if rs is not None and (emb is None or emb.rows is None):
        x = rs.take_rows(x)
    remat = remat and mode == "train" and torch.is_grad_enabled()
    split = tp if rs is None else rs
    for lo in range(pk, n, cfg.scan_unit):
        hi = min(lo + cfg.scan_unit, n)
        if remat:
            x, aux = checkpoint(span, lo, hi, x, aux, split,
                                use_reentrant=False)
        else:
            x, aux = span(lo, hi, x, aux, split)
    head = _head_split(cfg, tp)
    if rs is not None:  # the final norm on the rank's rows, then all rows
        x = rms_norm(x, rs.row_param(params["final_norm"]), cfg.norm_eps)
        x = rs.rows_gather(x, partial=head is not None)
        head = None  # the gather's backward sums the head's partials
    if last_only:
        x = x[:, -1:, :]
    if rs is None:
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = logits_apply(params["embed"], x, transpose=True, tp=head)
    else:
        logits = logits_apply(params["lm_head"], x, transpose=False,
                              tp=head)
    return logits, new_caches, aux


def _head_split(cfg: ArchConfig, tp):
    """``tp`` when the head's vocab is split over ``model``, else None."""
    return split_on(tp, "embed" if cfg.tie_embeddings else "lm_head")


def nll_loss(logits: torch.Tensor, labels: torch.Tensor, aux: torch.Tensor,
             aux_weight: float = 0.01, tp=None) -> tuple[torch.Tensor, dict]:
    """The JAX ``loss_fn``'s arithmetic on given logits: f32 logsumexp
    minus the gold logit, its mean, plus ``aux_weight`` times the aux
    loss.  The JAX version picks the gold logit by a one-hot einsum, which
    stays partitionable over a vocab sharded on a mesh; a gather gives the
    same value.  With ``tp`` the logits are this rank's vocab range: the
    logsumexp's maximum and its sum of exponentials are all-reduced over
    ``model`` (``torch.logsumexp``'s formula), and the gold logit comes
    from the rank whose range holds the label (an all-reduce of it and
    the other ranks' zeros)."""
    logits = logits.float()
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        top = tp.max(logits.amax(dim=-1))
        logz = top + torch.log(tp.reduce(
            torch.exp(logits - top[..., None]).sum(dim=-1)))
        V = logits.shape[-1]
        local = labels.long() - tp.range(V)[0]
        inside = (local >= 0) & (local < V)
        gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])
        gold = tp.reduce(gold[..., 0].masked_fill(~inside, 0))
    nll = torch.mean(logz - gold)
    total = nll + aux_weight * aux
    return total, {"nll": nll, "aux": aux}


def loss_fn(params: ParamTree, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, backend: str = "ref",
            aux_weight: float = 0.01, remat: bool = True,
            tp=None) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL plus the weighted MoE aux loss of a train-mode
    forward at the JAX default compute type (bf16) -> (total, {"nll",
    "aux"}).  ``backend="ref"`` by default, as the JAX trainer: no kernel
    has a backward, so training runs autograd through the plain
    versions.  ``tp``: the forward's ``model`` split, the vocab-parallel
    loss with it."""
    logits, _, aux = forward(params, cfg, tokens, mode="train",
                             backend=backend, remat=remat, tp=tp)
    return nll_loss(logits, labels, aux, aux_weight,
                    tp=_head_split(cfg, tp))
