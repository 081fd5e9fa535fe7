"""Logical-axis -> mesh-axis rules (the port of ``repro.parallel.logical``).

Every parameter has logical axis names (``models.model.logical_axes``,
the JAX ``Param`` axes keyed by the port's parameter names).  A rule set
maps logical names to mesh axes; ``spec_for`` also enforces divisibility
(a dimension that does not divide the mesh axis is replicated instead:
qwen1.5's 20 query heads on a 16-way model axis, or 8 KV heads) and uses
each mesh axis once.

A spec is this module's ``PartitionSpec``: a tuple holding, per array
dimension, a mesh-axis name, a tuple of names, or None, with trailing
Nones dropped; it equals the JAX ``PartitionSpec``'s tuple.  A mesh is a
``parallel.sharding.RankMesh`` or anything with a ``.shape`` dict of axis
sizes (the production meshes of ``launch.mesh`` have no ranks behind
them).

How the port's train step uses the specs (``train.train_loop``): every
rank holds the slice of each parameter and of both AdamW moments that its
coordinates on the spec's mesh axes select (ZeRO-3 / FSDP over ``data``
through the ``embed`` rule).  A spec also decides what a rank computes
(``model_parts``): the dimension it puts on ``model`` (heads, kv heads,
mlp, experts, Mamba's inner channels, RWKV's heads x dim, the vocab) is
never gathered over ``model``, and the rank computes only its range of
it (tensor and expert parallelism, ``parallel.tensor_parallel``); only
the spec's other axes, the FSDP axes (``fsdp_axes``: ``data`` and
``pod``), are all-gathered before a layer's forward and reduce-scattered
after its backward.  A dimension that ``spec_for`` leaves whole is
computed whole, as in the reference.

Under ``RULES_EP_DATA`` the experts of an MoE leaf lie on ``data``
(``expert_data_leaves``): such a leaf's ``data`` part is what the rank
computes with, so it is never gathered (nor its gradient reduce-scattered);
the tokens travel to the experts instead (an all-to-all over ``data``,
``tensor_parallel.ExpertSplit``).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

# base rules: logical axis name -> mesh axis name (None = replicate)
RULES_TP_FSDP: dict[str, str | None] = {
    "vocab": "model",
    "heads": "model",
    "heads_x_dim": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "inner": "model",
    "embed": "data",  # FSDP / ZeRO-3
    "layers": None,
    "head_dim": None,
    "conv": None,
    "state": None,
    "state_proj": None,
    "lora": None,
    "embed_out": None,
    "expert_unsharded": None,
}

# pure data-parallel baseline
RULES_DP_ONLY: dict[str, str | None] = {k: None for k in RULES_TP_FSDP}

# EP=DP variant: experts shard over the data axis; the "embed" FSDP rule
# yields to the expert axis on expert weights (each mesh axis used once)
RULES_EP_DATA: dict[str, str | None] = dict(RULES_TP_FSDP, expert="data")


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: ``PartitionSpec("data",
    None, "model")``; a tuple, so it compares equal to the JAX spec's
    tuple."""

    def __new__(cls, *parts):
        # a one-axis tuple is that axis, as JAX normalises it
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` (a name, a tuple of names, or None)."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def spec_for(shape: tuple[int, ...], axes: tuple[str, ...],
             rules: Mapping[str, str | None], mesh) -> PartitionSpec:
    """PartitionSpec for one parameter, with divisibility fallback and
    single-use-per-mesh-axis enforcement."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    used: set[str] = set()
    parts: list[str | None] = []
    for dim, name in zip(shape, axes):
        mx = rules.get(name)
        if mx is None or mx in used or dim % mesh_axis_size(mesh, mx) != 0:
            parts.append(None)
        else:
            parts.append(mx)
            used.add(mx)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def param_shardings(params, rules, mesh) -> dict:
    """``{name: PartitionSpec}`` for every parameter of a ``ParamTree``
    (concrete, or ``abstract_params``' on the ``meta`` device) or of a
    mapping keyed by its names, keyed as ``models.model.named_tensors``
    keys them.  A layer's axes are the JAX unit slice's (the scan's
    "layers" axis, which every rule set replicates, dropped): the port
    stores layers unstacked."""
    from ..models.model import named_tensors, param_axes

    return {name: spec_for(tuple(t.shape), param_axes(name), rules, mesh)
            for name, t in named_tensors(params).items()}


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that jointly shard the global batch."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


MODEL_AXIS = "model"


class ModelPart(NamedTuple):
    """A parameter's dimension split over ``model`` and one rank's
    range ``[lo, hi)`` of it."""

    dim: int
    lo: int
    hi: int


def fsdp_axes(mesh) -> tuple[str, ...]:
    """The mesh axes a layer is all-gathered over before its forward (and
    its gradient reduce-scattered over after its backward): every axis
    but ``model``, in the mesh's order."""
    return tuple(a for a in mesh.shape if a != MODEL_AXIS)


def model_dim(spec) -> int | None:
    """The dimension that ``spec`` puts on ``model``, or None when the
    parameter is whole over it."""
    for d, a in enumerate(spec):
        if a == MODEL_AXIS:
            return d
    return None


def expert_data_leaves(specs: Mapping) -> frozenset:
    """The names of the parameters (``specs``: ``{name: PartitionSpec}``)
    whose ``expert`` dimension the spec puts on ``data``:
    ``RULES_EP_DATA``'s MoE leaves, ``("data", None, "model")`` for
    ``wi_gate``/``wi_up`` and ``("data", "model")`` for ``wo``."""
    from ..models.model import param_axes

    out = set()
    for name, spec in specs.items():
        for d, a in enumerate(param_axes(name)):
            if a == "expert" and d < len(spec) and spec[d] == "data":
                out.add(name)
    return frozenset(out)


def fsdp_spec(spec) -> PartitionSpec:
    """``spec`` over the FSDP axes alone (``model`` dropped): how the
    rank's ``model`` part of a parameter is cut over the ranks that hold
    the other parts of it."""
    return PartitionSpec(*(None if a == MODEL_AXIS else a for a in spec))


def model_parts(shapes: Mapping[str, tuple], specs: Mapping,
                mesh, coord: int) -> dict[str, ModelPart | None]:
    """``{name: ModelPart or None}``: for every parameter (``shapes``,
    ``{name: full shape}``; ``specs`` as ``param_shardings`` gives them),
    the dimension its spec puts on ``model`` and the range of it that the
    rank at ``model`` coordinate ``coord`` holds and computes, or None
    for a parameter the spec leaves whole over ``model`` (every rank
    computes what reads it whole)."""
    n = mesh.shape.get(MODEL_AXIS, 1)
    if not 0 <= coord < n:
        raise ValueError(f"model coordinate {coord} outside 0..{n - 1}")
    out: dict = {}
    for name, shape in shapes.items():
        d = model_dim(specs[name])
        if d is None or n == 1:
            out[name] = None
            continue
        local = shape[d] // mesh_axis_size(mesh, specs[name][d])
        out[name] = ModelPart(d, coord * local, (coord + 1) * local)
    return out
