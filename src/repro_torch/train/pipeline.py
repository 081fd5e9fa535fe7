"""GPipe-style pipeline parallelism over a mesh axis of ``torch.
distributed`` ranks (the port of ``repro.train.pipeline``).

Stage s is the rank at coordinate s of the mesh's ``axis_name`` and runs
its slice of the stacked stage parameters.  M microbatches flow through
the GPipe schedule of the JAX version: at tick t, stage s runs microbatch
t - s and hands its activation to stage s + 1, here by point-to-point
``send``/``recv`` where JAX uses ``collective_permute``.  Bubble
fraction = (S - 1) / (M + S - 1).  One process a rank, as in
``parallel.sharding``: the activations travel over the mesh's gloo group
as host tensors (NCCL refuses two ranks on one card), and the last
stage's result is broadcast so that every rank returns it (the JAX
version's masked ``psum``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from ..parallel.sharding import RankMesh


def _stage_slice(tree, s: int):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    return tree[s]


def _neighbour(mesh: RankMesh, axis: str, step: int) -> int:
    """The global rank one step along ``axis`` from this rank."""
    i = mesh.axes.index(axis)
    return mesh.rank + step * math.prod(mesh.sizes[i + 1:])


def _axis_group(mesh: RankMesh, axis: str):
    """The gloo group of the ranks that differ from this one only along
    ``axis`` (the mesh's own group for a 1-D mesh).  Every rank makes
    every line's group, in the same order: ``new_group`` is collective."""
    if mesh.group is None or mesh.shape[axis] == mesh.size:
        return mesh.group
    stride = math.prod(mesh.sizes[mesh.axes.index(axis) + 1:])
    mine = None
    for r in range(mesh.size):
        first = r - mesh.coord(axis, r) * stride
        if r != first:
            continue
        line = [first + k * stride for k in range(mesh.shape[axis])]
        g = dist.new_group(line, backend="gloo")
        if mesh.rank in line:
            mine = g
    return mine


def gpipe_local(stage_fn: Callable, my_stage_params, x_mbs: torch.Tensor,
                mesh: RankMesh, axis_name: str, num_stages: int,
                group=None) -> torch.Tensor:
    """This rank's stage of the schedule.  ``x_mbs`` [M, mb, ...] is read
    on stage 0; returns [M, mb, ...] outputs, meaningful on the last
    stage (zeros elsewhere).  ``group``: the ranks along the axis."""
    M = x_mbs.shape[0]
    s = mesh.coord(axis_name)
    out = torch.zeros_like(x_mbs)
    pending = []
    for t in range(M + num_stages - 1):
        mb = t - s
        if not 0 <= mb < M:
            continue
        if s == 0:
            x_in = x_mbs[mb]
        else:
            buf = torch.empty(x_mbs.shape[1:], dtype=x_mbs.dtype)
            dist.recv(buf, _neighbour(mesh, axis_name, -1), group=group)
            x_in = buf.to(x_mbs.device)
        y = stage_fn(my_stage_params, x_in)
        out[mb] = y
        if s < num_stages - 1:
            host = y.detach().to("cpu", copy=True).contiguous()
            pending.append(dist.isend(host, _neighbour(mesh, axis_name, 1),
                                      group=group))
    for req in pending:
        req.wait()
    return out


def make_gpipe(mesh: RankMesh, stage_fn: Callable, axis_name: str = "pod"):
    """-> run(stage_params [S, ...] (a tensor or a dict of them), x_mbs [M,
    ...]) -> outputs [M, ...], the last stage's, on every rank of the
    mesh (each line along ``axis_name`` runs its own pipeline).  Every
    rank calls ``make_gpipe``, then ``run`` with the same arguments."""
    num_stages = mesh.shape[axis_name]
    group = _axis_group(mesh, axis_name)

    def run(stage_params, x_mbs: torch.Tensor) -> torch.Tensor:
        sp = _stage_slice(stage_params, mesh.coord(axis_name))
        out = gpipe_local(stage_fn, sp, x_mbs, mesh, axis_name, num_stages,
                          group)
        if num_stages == 1:
            return out
        last = _neighbour(mesh, axis_name,
                          num_stages - 1 - mesh.coord(axis_name))
        host = out.detach().to("cpu", copy=True).contiguous()
        dist.broadcast(host, last, group=group)
        return host.to(x_mbs.device)

    return run
