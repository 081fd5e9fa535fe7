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
through the ``embed`` rule); a layer's parameters are all-gathered before
its forward and its gradient reduce-scattered back onto the slices.  The
JAX package's TP rules (heads, mlp, experts over ``model``) shard storage
the same way, and the port replicates the compute over ``model``.
"""
from __future__ import annotations

from typing import Mapping

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
