"""shape-discipline: serve-path sizing must stay power-of-two.

The port of ``repro.analysis.passes.shape_discipline``, the same rule
over the port's serve modules.  Every distinct batch/bucket shape that
reaches the hop pipeline is a new key of the CUDA-graph cache
(``core.device_search._graph_key``) — a chunk run eagerly, then
captured — as it is a separate XLA compile in the JAX package; the serve
engine keeps the set of captured shapes bounded by quantizing all sizing
to pow2 (or the 1.5*pow2 half-steps of ``_bucket_ceil``).  A non-pow2
literal wired into a wave/bucket/batch size silently multiplies the
captured shapes and resurfaces as a p99 spike on the first cold shape.
This pass checks, inside ``serve/`` modules:

- integer literals assigned (or defaulted, for dataclass fields /
  keyword defaults) to sizing-named targets must be powers of two;
- explicit integer dimension literals in ``zeros/ones/full/empty``
  array constructors must be powers of two;
- sizing values that are *computed* must route through ``_pow2ceil`` /
  ``_bucket_ceil`` (non-literal expressions are accepted — the route
  helpers are the only way to build one from data).
"""
from __future__ import annotations

import ast
import re

from ..callgraph import ModuleFile, RepoIndex, dotted
from ..findings import Finding

NAME = "shape-discipline"
DESCRIPTION = "non-pow2 sizing literals in the serve path"
SCOPE = r"\.serve\.|\.lifecycle$"

_SIZING_RE = re.compile(
    r"(?:^|_)(?:wave|bucket|batch|cap|slots?|width|chunk|pad|slab)",
    re.IGNORECASE,
)
_ALLOC_CALLS = {"zeros", "ones", "full", "empty"}
_ROUTE_CALLS = {"_pow2ceil", "pow2ceil", "_bucket_ceil", "bucket_ceil"}


def _is_pow2(v: int) -> bool:
    """Legal sizing literals: 0 (empty alloc / counter init), powers of
    two, and the 1.5*pow2 half-steps of ``_bucket_ceil`` (8, 12, 16, 24,
    32, 48, ...) — the quantization the compaction buckets already use."""
    if v == 0:
        return True
    if v > 0 and (v & (v - 1)) == 0:
        return True
    return v > 0 and v % 3 == 0 and ((v // 3) & (v // 3 - 1)) == 0


def _literal_violations(node: ast.AST) -> list[ast.Constant]:
    """Non-pow2 int literals inside a sizing value expression.  Accepts
    pow2 literals, route-helper calls, and anything non-literal; rejects
    bare non-pow2 ints (also inside tuples and min/max wrappers)."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or not isinstance(node.value, int):
            return []
        return [] if _is_pow2(node.value) else [node]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            out.extend(_literal_violations(e))
        return out
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        if d and d.split(".")[-1] in _ROUTE_CALLS:
            return []
        if d in ("min", "max"):
            out = []
            for a in node.args:
                out.extend(_literal_violations(a))
            return out
        return []
    return []


def run(index: RepoIndex, files: list[ModuleFile]) -> list[Finding]:
    out: list[Finding] = []

    def flag(mf: ModuleFile, node: ast.AST, what: str, v: int) -> None:
        out.append(Finding(
            pass_name=NAME, path=mf.rel, line=node.lineno,
            message=f"non-pow2 sizing literal {v} for {what} "
                    f"(route through _pow2ceil/_bucket_ceil)"))

    for mf in files:
        for node in ast.walk(mf.tree):
            targets: list[tuple[str, ast.AST]] = []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    name = t.id if isinstance(t, ast.Name) else (
                        t.attr if isinstance(t, ast.Attribute) else None)
                    if name is not None:
                        targets.append((name, node.value))
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                t = node.target
                name = t.id if isinstance(t, ast.Name) else (
                    t.attr if isinstance(t, ast.Attribute) else None)
                if name is not None:
                    targets.append((name, node.value))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                pos = args.posonlyargs + args.args
                for a, dflt in zip(pos[len(pos) - len(args.defaults):],
                                   args.defaults):
                    targets.append((a.arg, dflt))
                for a, dflt in zip(args.kwonlyargs, args.kw_defaults):
                    if dflt is not None:
                        targets.append((a.arg, dflt))
            elif isinstance(node, ast.Call):
                d = dotted(node.func)
                if d and d.split(".")[-1] in _ALLOC_CALLS and node.args:
                    shape = node.args[0]
                    for bad in _literal_violations(shape):
                        flag(mf, bad, f"a `{d}` dimension", bad.value)
                continue
            for name, value in targets:
                if not _SIZING_RE.search(name):
                    continue
                for bad in _literal_violations(value):
                    flag(mf, bad, f"`{name}`", bad.value)
    return sorted(set(out))
