"""wowlint for the port — repo-specific static analysis + runtime guard.

The port of ``repro.analysis``.  The contracts the port's performance
rests on (no host round-trips or tensor-driven branches inside a
captured hop chunk or a kernel launch wrapper, pow2-only chunk shapes in
the serve path, f32-everywhere distance math, no stale reads of a buffer
written in place, log->fsync->ack durability ordering) are invisible to
generic linters: they are properties of *how the code is captured and
replayed*, not of the Python surface.  This package enforces them:

- ``repro_torch.analysis.passes`` — AST passes over the lint surface
  (capture-purity, shape-discipline, dtype-drift, inplace-safety,
  durability-ordering, replication-ordering), built on the call-graph /
  taint machinery in ``repro_torch.analysis.callgraph``.
- ``repro_torch.analysis.compile_guard`` — ``CaptureCounter``, the
  runtime guard tests use to assert "zero captures and kernel builds
  after ``warmup()``".
- ``python -m repro_torch.analysis --fail-on-findings`` — the CI entry
  point (clean-or-fail; ``# wowlint: disable=<pass>`` suppresses a line,
  ``wowlint_torch_baseline.json`` accepts findings; see ``ANALYSIS.md``
  for the reference's catalog).

Nothing here imports ``jax`` or ``repro``: the port keeps its own copy of
the AST machinery.
"""
from .compile_guard import CaptureCounter, trace_compiles
from .engine import LintEngine, lint_paths, lint_repo
from .findings import Finding

__all__ = [
    "CaptureCounter",
    "Finding",
    "LintEngine",
    "lint_paths",
    "lint_repo",
    "trace_compiles",
]
