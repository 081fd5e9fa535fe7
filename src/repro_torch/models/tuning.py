"""Process-wide knobs of the LM path (the port of ``repro.models.tuning``):
every field of the JAX ``Tuning``, its presets and ``seq_spec``.

Knobs that change numbers, computed as the JAX package computes them:

  attn_blocked_min_t   the plain attention evaluates query rows in blocks
                       (``kernels.ref.mha_ref(block_q=...)``) once the
                       query length reaches this, so the [Tq, Tk] score
                       matrix never materialises whole.
  attn_block_q         the query block of that path.
  tp_reduce_dtype      the row-parallel products (attention ``wo``, MLP
                       ``wo``, Mamba ``out_proj``, RWKV's channel-mix
                       output) are rounded to this dtype, then cast back
                       to the input's (``layers.rp_matmul``, the JAX
                       ``rp_einsum``); with the product split over
                       ``model`` its partial sums are all-reduced in this
                       dtype (the wire dtype of JAX's psum).  Unset, they
                       are all-reduced in f32 and rounded once
                       (``layers.reduce_product``).
  moe_shard_dispatch   the MoE layer dispatches by the 2-D gather
                       ``disp[e, c] = x[order[starts[e] + c]]`` (the JAX
                       ``moe2d`` path) instead of the flat scatter; the
                       numbers are the same.
  rwkv_chunk           chunk of ``wkv6_chunked`` (0 = the config's).
  mamba_chunk          selective-scan chunk (0 = the config's), passed to
                       ``ops.mamba_scan`` as the JAX mixer passes it; it
                       only sets the JAX scan's checkpoint boundaries.

Knobs that place the work of a meshed step (JAX pins activations to
mesh axes by ``with_sharding_constraint``; the port computes what the pin
puts on each rank):

  attn_seq_axis        "model": sequence-parallel attention where the
                       query heads are whole over ``model`` (they do not
                       divide it; the dry run clears the knob per cell
                       otherwise, as the reference does).  A rank attends
                       for its slice of the query rows and the rows are
                       all-gathered over ``model`` (``models.attention``).
                       ``seq_spec`` states the JAX pin.
  cache_seq_shard      a decode KV cache whose kv heads do not divide
                       ``model`` holds ``S / n`` of its slots a rank,
                       merged by flash-decoding (``models.attention``;
                       ``parallel.sharding.cache_sharding`` states the
                       JAX spec).
  batch_axes           set per dry-run cell to the rows' split.
  residual_spec        the residual stream's pin inside the JAX layer
                       scan (``(("data", "model"), None, None)``: DP over
                       both axes); set by no preset and no entry point,
                       only by ``set_tuning``.  Where it puts ``model`` on
                       the batch or the sequence dimension
                       (``residual_dim``), the port splits that dimension
                       of the residual stream over ``model`` from the
                       first scan unit to the last (``models.model.
                       forward``): norms and residual adds run on a
                       rank's rows, a split product's input is gathered
                       and its output reduce-scattered
                       (``parallel.tensor_parallel``).  ``data``/``pod``
                       on the batch follow the rows' split the step
                       already has; ``model`` on the embed dimension
                       keeps the residual whole (inert: it would add a
                       norm all-reduce to every block).

Knobs that the port's step never reads (``SHARDING_ONLY``):

  moe_expert_axis      in the reference it only pins the dispatch
                       buffers to a mesh axis.  Where the experts live
                       comes from the rules (``RULES_EP_DATA`` puts
                       ``expert`` on ``data``), and the port's dispatch
                       follows the expert leaves' specs: experts on
                       ``data`` get an all-to-all over ``data``
                       (``models.moe``), experts on ``model`` their
                       rank's slots.  The knob adds nothing to that.

The dry run records every knob's value and names the set
``SHARDING_ONLY`` knobs, and a ``residual_spec`` that splits neither
the batch nor the sequence over ``model``, in ``tuning_inert``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Tuning:
    attn_blocked_min_t: int = 8192
    attn_block_q: int = 2048
    tp_reduce_dtype: str | None = None
    # sequence-parallel attention over this mesh axis (JAX: used when the
    # query heads do not divide the model axis)
    attn_seq_axis: str | None = None
    batch_axes: tuple = ()
    # decode KV caches of non-divisible-head archs shard their sequence
    # dim over model (flash-decoding split)
    cache_seq_shard: bool = False
    # MoE: the [E, C+1, d] 2-D gather dispatch instead of the flat scatter
    moe_shard_dispatch: bool = False
    # mesh axis the JAX MoE dispatch buffers are pinned to
    moe_expert_axis: str = "model"
    # residual-stream sharding constraint inside the JAX layer scan
    residual_spec: tuple | None = None
    mamba_chunk: int = 0
    rwkv_chunk: int = 0


TUNING = Tuning()

# Knobs that are only a ``with_sharding_constraint`` in the JAX package and
# that the port's step never reads (module docstring): the experts' place
# comes from the specs.
SHARDING_ONLY = ("moe_expert_axis",)


def residual_dim() -> int | None:
    """The dimension of the residual stream ``[B, T, d]`` that
    ``TUNING.residual_spec`` puts on ``model``: 0 (the batch) or 1 (the
    sequence); None when the knob is unset or puts ``model`` on the embed
    dimension or nowhere."""
    spec = TUNING.residual_spec
    for dim, entry in enumerate(tuple(spec or ())[:2]):
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else tuple(entry))
        if "model" in axes:
            return dim
    return None


def inert_knobs() -> list[str]:
    """The knobs set away from their defaults that change nothing in the
    port's step: the sharding-only ones, and a ``residual_spec`` that
    splits neither the batch nor the sequence over ``model``.  A dry-run
    record made under them has the untuned record's terms."""
    default = Tuning()
    inert = [k for k in SHARDING_ONLY
             if getattr(TUNING, k) != getattr(default, k)]
    if TUNING.residual_spec is not None and residual_dim() is None:
        inert.insert(0, "residual_spec")
    return inert


def set_tuning(**kw) -> Tuning:
    for k, v in kw.items():
        if not hasattr(TUNING, k):
            raise AttributeError(f"unknown tuning knob {k!r}")
        setattr(TUNING, k, v)
    return TUNING


def apply_preset(names: str) -> Tuning:
    """Comma-separated preset list, e.g. 'blocked_attn,bf16_reduce'."""
    for name in filter(None, names.split(",")):
        if name == "blocked_attn":
            TUNING.attn_blocked_min_t = 2048
        elif name == "bf16_reduce":
            TUNING.tp_reduce_dtype = "bfloat16"
        elif name == "dense_attn":
            TUNING.attn_blocked_min_t = 1 << 30
        elif name == "f32_reduce":
            TUNING.tp_reduce_dtype = None
        elif name == "seq_parallel_attn":
            TUNING.attn_seq_axis = "model"
        elif name == "cache_seq_shard":
            TUNING.cache_seq_shard = True
        elif name == "moe2d":
            TUNING.moe_shard_dispatch = True
        elif name == "moe_ep_data":
            TUNING.moe_shard_dispatch = True
            TUNING.moe_expert_axis = "data"
        elif name.startswith("mamba_chunk="):
            TUNING.mamba_chunk = int(name.split("=")[1])
        elif name.startswith("rwkv_chunk="):
            TUNING.rwkv_chunk = int(name.split("=")[1])
        elif name == "opt":  # the full optimized set
            apply_preset(
                "blocked_attn,bf16_reduce,seq_parallel_attn,cache_seq_shard,"
                "moe2d,rwkv_chunk=256"
            )
        else:
            raise ValueError(f"unknown tuning preset {name!r}")
    return TUNING


def seq_spec(extra_dims: int = 2):
    """PartitionSpec (batch_axes, attn_seq_axis, *None) or None if unset."""
    from ..parallel.logical import PartitionSpec as P

    if TUNING.attn_seq_axis is None:
        return None
    b = tuple(TUNING.batch_axes) or None
    return P(b, TUNING.attn_seq_axis, *([None] * extra_dims))
