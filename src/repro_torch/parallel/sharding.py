"""Rank meshes: the sharded WoW build's 1-D build mesh and the serving
function's ``(data, model)`` mesh, over ``torch.distributed`` ranks; and
the per-(arch x shape x mesh) input and cache specs of the LM
(``token_sharding``, ``seq_shard_axis``, ``cache_sharding``; the port of
the rest of ``repro.parallel.sharding``).

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh`` of devices through ``shard_map``.  PyTorch's form of
that is one process per device (SPMD): every rank runs the same program on
its own device and the ranks meet only in collectives.  A ``RankMesh``
names the mesh's axes and sizes, this rank, this rank's device and the
process group its host-side gathers use.

The gathers move host arrays (the phase-1 candidate sets, the serving
results), so they run on CPU tensors over a gloo group: the default group
when it is gloo, else a gloo group over the same ranks
(``torch.distributed.new_group(backend="gloo")``).  Two reasons: the build's
phase-2 commit consumes host arrays anyway, and NCCL refuses two ranks on
one card.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --build-backend sharded --mesh 2x1 --device cpu
"""
from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

_GLOO_GROUPS: dict = {}  # default group -> its gloo twin (NCCL default)
_SUB_GROUPS: dict = {}  # (parent group, member ranks) -> their group


@dataclass(frozen=True)
class RankMesh:
    """A mesh of ``torch.distributed`` ranks laid out row-major over
    ``axes`` (rank = sum of coordinate x stride, the last axis fastest, as
    a ``jax.sharding.Mesh`` lays out its devices).  ``group`` is None for
    a one-rank mesh, which needs no ``torch.distributed`` at all."""

    axes: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    device: torch.device
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coord(self, axis: str, rank: int | None = None) -> int:
        """``rank``'s index along ``axis`` (default: this rank's)."""
        rank = self.rank if rank is None else rank
        i = self.axes.index(axis)
        return (rank // math.prod(self.sizes[i + 1:])) % self.sizes[i]

    def sub(self, axes) -> "RankMesh":
        """The mesh of the ranks that share this rank's coordinates on
        every axis but ``axes``: those axes (in this mesh's order), this
        rank's place among those ranks, and a gloo group over them (None
        for one rank).  The train step's ``model`` group and its FSDP
        group (``data`` and ``pod``) are two such meshes.  Only the
        members make a group (``use_local_synchronization``), once."""
        axes = tuple(a for a in self.axes if a in axes)
        sizes = tuple(self.shape[a] for a in axes)
        coords = [self.coord(a) for a in self.axes]
        strides = [math.prod(self.sizes[i + 1:]) for i in
                   range(len(self.axes))]
        members = []
        for combo in itertools.product(*(range(n) for n in sizes)):
            c = list(coords)
            for a, v in zip(axes, combo):
                c[self.axes.index(a)] = v
            members.append(sum(x * st for x, st in zip(c, strides)))
        group = None
        if len(members) > 1:
            group = _subgroup(self.group, tuple(members))
        return RankMesh(axes, sizes, members.index(self.rank), self.device,
                        group)

    def all_gather(self, a: np.ndarray) -> list[np.ndarray]:
        """Every rank's ``a`` (same shape and dtype on every rank), in rank
        order, over the mesh's gloo group."""
        if self.group is None:
            return [a]
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(self.size)]
        torch.distributed.all_gather(parts, t, group=self.group)
        return [p.numpy() for p in parts]


@dataclass(frozen=True)
class BuildMesh(RankMesh):
    """The 1-D mesh of a sharded build (``insert_batch(backend=
    "sharded")``): ``shards`` ranks along ``axis``."""

    @property
    def axis(self) -> str:
        return self.axes[0]

    @property
    def shards(self) -> int:
        return self.sizes[0]


def rank_device(device=None) -> torch.device:
    """``device=None``: ``cuda:{LOCAL_RANK % device_count}``, so ranks
    share one card when there is one."""
    from .. import resolve_device

    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without CUDA
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


def _gloo_group():
    """The group host gathers use: the default group when it is gloo, else
    (made once, by every rank: ``new_group`` is collective) a gloo group
    over the same ranks."""
    dist = torch.distributed
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    key = id(dist.group.WORLD)
    if key not in _GLOO_GROUPS:
        _GLOO_GROUPS[key] = dist.new_group(backend="gloo")
    return _GLOO_GROUPS[key]


def _subgroup(parent, members: tuple[int, ...]):
    """A group over ``members`` (global ranks, ascending) of the default
    group: gloo, or the default group's backend when that is gloo or the
    dry run's ``fake``; made once by the members alone."""
    dist = torch.distributed
    key = (id(parent), members)
    if key not in _SUB_GROUPS:  # the entry keeps ``parent`` (its id) alive
        backend = dist.get_backend()
        _SUB_GROUPS[key] = (parent, dist.new_group(
            list(members), backend=None if backend in ("gloo", "fake")
            else "gloo", use_local_synchronization=True))
    return _SUB_GROUPS[key][1]


def _mesh(cls, axes: tuple[str, ...], sizes: tuple[int, ...], device):
    total = math.prod(sizes)
    if total < 1 or min(sizes) < 1:
        raise ValueError(f"a mesh needs >= 1 rank on every axis, got "
                         f"{dict(zip(axes, sizes))}")
    dist = torch.distributed
    if total == 1:  # one rank: no process group, no gathers
        return cls(axes, sizes, 0, rank_device(device), None)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"a mesh of {total} ranks {dict(zip(axes, sizes))} needs an "
            f"initialised torch.distributed default group of world size "
            f"{total}: start one process per rank (torchrun "
            f"--nproc-per-node {total} ...), or pass 1"
        )
    world = dist.get_world_size()
    if world != total:
        raise ValueError(
            f"a mesh of {total} ranks {dict(zip(axes, sizes))} needs world "
            f"size {total}, but the default group has {world} ranks "
            f"(torchrun --nproc-per-node {total} ...)"
        )
    return cls(axes, sizes, dist.get_rank(), rank_device(device),
               _gloo_group())


def build_mesh(shards: int | None = None, axis: str = "build",
               device=None) -> BuildMesh:
    """1-D build mesh of ``shards`` ranks (default: the world size of the
    initialised default group, else 1).  ``shards`` 1 is a one-rank mesh
    with no process group; more need a default group of exactly that
    world size (one process per rank) and raise ``ValueError`` otherwise.
    ``device=None`` puts the rank on ``cuda:{LOCAL_RANK % device_count}``.
    Every rank must call this (it may create the gloo group)."""
    if shards is None:
        dist = torch.distributed
        shards = (dist.get_world_size()
                  if dist.is_available() and dist.is_initialized() else 1)
    shards = int(shards)
    if shards < 1:
        raise ValueError("build mesh needs >= 1 shard")
    return _mesh(BuildMesh, (axis,), (shards,), device)


def serving_mesh(data: int, model: int = 1, device=None) -> RankMesh:
    """The ``(data, model)`` mesh of ``core.distributed.make_serving_fn``:
    ``data * model`` ranks (the rules of ``build_mesh``)."""
    return _mesh(RankMesh, ("data", "model"), (int(data), int(model)),
                 device)


# ------------------------------------------------ LM input and cache specs
def _dp(mesh, batch: int) -> tuple[str, ...] | None:
    """Largest prefix of (pod, data) that divides the batch."""
    from .logical import batch_axes

    axes = []
    size = 1
    for a in batch_axes(mesh):
        if batch % (size * mesh.shape[a]) == 0:
            axes.append(a)
            size *= mesh.shape[a]
    return tuple(axes) or None


def token_sharding(mesh, batch: int):
    """The spec of a [B, ...] token batch: B over ``_dp``."""
    from .logical import PartitionSpec as P

    return P(_dp(mesh, batch))


def seq_shard_axis(mesh, batch: int, seq: int) -> str | None:
    """Sequence-parallel axis for long-context serving: used when the batch
    cannot occupy the data axis (long_500k: batch 1)."""
    if batch % mesh.shape["data"] != 0 and seq % mesh.shape["data"] == 0:
        return "data"
    return None


def cache_sharding(cfg, mesh, batch: int, seq: int):
    """-> a function from a decode cache (``models.init_cache``'s list of
    per-layer states) to the same list of states holding a spec per
    tensor: the spec the JAX package gives the same leaf of its layout
    (``[n_units, B, ...]`` for a layer of the scan, as
    ``models.to_jax_values`` stacks parameters), without the unit axis.

    KV caches [B, S, Hkv, D]: batch over (pod, data) when divisible, else
    the sequence over data (flash-decoding style); heads over model when
    divisible, else with ``TUNING.cache_seq_shard`` the sequence over
    model.  SSM states [B, ...]: batch if divisible, else replicated."""
    from ..models.model import _prefix_len
    from ..models.tuning import TUNING
    from .logical import PartitionSpec as P

    dp = _dp(mesh, batch)
    sp = seq_shard_axis(mesh, batch, seq)
    pk = _prefix_len(cfg)
    n_units = (cfg.num_layers - pk) // cfg.scan_unit

    def spec_of(shp) -> P:  # the JAX rule on the JAX layout's shape
        if len(shp) >= 3 and shp[1] == batch:
            if len(shp) - 1 == 4 and shp[2] >= min(seq, 1024) // 2:
                hx = "model" if shp[3] % mesh.shape["model"] == 0 else None
                sx = None
                if hx is None and TUNING.cache_seq_shard and \
                        shp[2] % mesh.shape["model"] == 0:
                    sx = "model"
                if dp is not None:
                    return P(None, dp, sx, hx, None)
                if sp is not None and shp[2] % mesh.shape["data"] == 0:
                    return P(None, None, sp, hx, None)
                return P(None, None, None, hx, None)
            if dp is not None:
                return P(None, dp)
            return P()
        if len(shp) >= 2 and shp[0] == batch and dp is not None:
            return P(dp)
        return P()

    def one(i: int, t) -> P:
        if i < pk:
            return spec_of(tuple(t.shape))
        return P(*spec_of((n_units, *t.shape))[1:])

    return lambda caches: [type(st)(*(one(i, t) for t in st))
                           for i, st in enumerate(caches)]

