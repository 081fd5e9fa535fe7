"""wowlint pass registry (the port's; see ``repro.analysis.passes``).

Each pass module exposes ``NAME``, ``DESCRIPTION``, ``SCOPE`` (a regex
matched against the dotted module name; ``None`` = whole surface) and
``run(index, files) -> list[Finding]`` where ``files`` is the
scope-filtered module list the engine hands it.
"""
from . import (
    donation_safety,
    dtype_drift,
    durability,
    jit_purity,
    replication_ordering,
    shape_discipline,
)

ALL_PASSES = (
    jit_purity,
    shape_discipline,
    dtype_drift,
    donation_safety,
    durability,
    replication_ordering,
)

BY_NAME = {p.NAME: p for p in ALL_PASSES}
