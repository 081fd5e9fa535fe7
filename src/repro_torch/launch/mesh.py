"""Production and host meshes (the port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.

``make_production_mesh`` is the reference's 16 x 16 ``(data, model)`` or
2 x 16 x 16 ``(pod, data, model)`` mesh as an ``AbstractMesh``: axis
names and sizes with no ranks behind them, which the dry run plans on
(``parallel.spec_for`` and ``param_shardings`` read only ``.shape``).
``make_host_mesh`` builds a ``parallel.RankMesh`` over the ranks of the
running ``torch.distributed`` world (one rank: no process group).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, laid out row-major as a
    ``RankMesh`` is, with no process group."""

    axes: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, shape)


def make_host_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                   device=None):
    """A ``RankMesh`` of ``prod(shape)`` ranks over ``axes``: the world of
    the initialised default group (which must have that size), or one
    rank with no group.  ``device=None`` puts the rank on
    ``cuda:{LOCAL_RANK % device_count}``."""
    from ..parallel.sharding import RankMesh, _mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ")
    return _mesh(RankMesh, tuple(axes), tuple(int(s) for s in shape),
                 device)
