"""inplace-safety: a buffer written in place is not read through a stale
name after the call.

The port of ``repro.analysis.passes.donation_safety`` (pass
``donation-safety``).  Where the JAX package donates a buffer to a jitted
update (``donate_argnums``: the arena scatters, the train step) and must
not touch the donated reference again, the port writes the buffer in
place: a later read of the same name sees the new contents, not the
values the reader had in hand, and nothing in the code says so.  The
rule is the reference's, unchanged: a surface callable *writes a
parameter in place* when its body calls a trailing-underscore method on
it (``copy_``, ``index_copy_``, ``scatter_``, ...) or stores into it by
subscript (``p[i] = v``), directly or transitively — a wrapper that
forwards its own parameter into an in-place position writes that
parameter too (a fixpoint, as the reference's).  At every call site the
written ``Name``/``self.attr`` argument must not be *loaded* again in a
later statement of the same block unless it is rebound first.  The
idiomatic shape — ``vstate = _visited_mark(vstate, ...)``, the writer
returning its buffer — rebinds in the same statement and passes.
"""
from __future__ import annotations

import ast

from ..callgraph import FuncInfo, ModuleFile, RepoIndex, dotted
from ..findings import Finding

NAME = "inplace-safety"
DESCRIPTION = "arguments written in place referenced after the call"
SCOPE = None


def _direct_writes(fi: FuncInfo) -> set[str]:
    """Parameters ``fi`` writes in place itself."""
    params = set(fi.params) - {"self", "cls"}
    out: set[str] = set()
    for node in ast.walk(fi.node):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr.endswith("_")
                and not node.func.attr.startswith("_")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in params):
            out.add(node.func.value.id)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in params):
                    out.add(t.value.id)
    return out


def _bound_args(call: ast.Call, callee: FuncInfo) -> dict[str, ast.AST]:
    """Callee parameter name -> the argument node it binds at ``call``
    (a method called through an attribute skips ``self``)."""
    params = callee.params
    offset = (1 if params and params[0] == "self"
              and isinstance(call.func, ast.Attribute) else 0)
    out: dict[str, ast.AST] = {}
    for i, a in enumerate(call.args):
        if i + offset < len(params) and not isinstance(a, ast.Starred):
            out[params[i + offset]] = a
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in params:
            out[kw.arg] = kw.value
    return out


def _writing_map(index: RepoIndex) -> dict[str, set[str]]:
    """qualname -> parameter names written in place, with one transitive
    step per fixpoint round for forwarding wrappers."""
    wr: dict[str, set[str]] = {}
    for fi in index.functions.values():
        direct = _direct_writes(fi)
        if direct:
            wr[fi.qualname] = direct
    for _ in range(8):
        changed = False
        for fi in index.functions.values():
            for call in (n for n in ast.walk(fi.node)
                         if isinstance(n, ast.Call)):
                callee = index.resolve_call(fi.mod, call.func, fi.cls)
                if callee is None or callee.qualname not in wr:
                    continue
                bound = _bound_args(call, callee)
                for p in wr[callee.qualname]:
                    arg = bound.get(p)
                    if (isinstance(arg, ast.Name) and arg.id in fi.params
                            and arg.id not in ("self", "cls")):
                        cur = wr.setdefault(fi.qualname, set())
                        if arg.id not in cur:
                            cur.add(arg.id)
                            changed = True
        if not changed:
            break
    return wr


def _target_names(stmt: ast.stmt) -> set[str]:
    """Dotted names rebound by this statement."""
    out: set[str] = set()
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    for t in targets:
        d = dotted(t)
        if d:
            out.add(d)
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                de = dotted(e)
                if de:
                    out.add(de)
    return out


def _loads_in(stmt: ast.stmt, name: str) -> ast.AST | None:
    """First Load of dotted ``name`` inside ``stmt`` (excluding stores)."""
    for sub in ast.walk(stmt):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            if not isinstance(getattr(sub, "ctx", None), ast.Load):
                continue
            if dotted(sub) == name:
                return sub
    return None


def _check_block(index: RepoIndex, fi: FuncInfo, body: list[ast.stmt],
                 wr: dict[str, set[str]], out: list[Finding]) -> None:
    for i, stmt in enumerate(body):
        for call in (n for n in ast.walk(stmt)
                     if isinstance(n, ast.Call)):
            callee = index.resolve_call(fi.mod, call.func, fi.cls)
            if callee is None or callee.qualname not in wr:
                continue
            rebound = _target_names(stmt)
            bound = _bound_args(call, callee)
            for p in sorted(wr[callee.qualname]):
                if p not in bound:
                    continue
                name = dotted(bound[p])
                if name is None or name in rebound:
                    continue  # non-name arg, or safe same-stmt rebind
                for later in body[i + 1:]:
                    if name in _target_names(later):
                        break  # rebound before any load
                    hit = _loads_in(later, name)
                    if hit is not None:
                        out.append(Finding(
                            pass_name=NAME, path=fi.mod.rel,
                            line=hit.lineno,
                            message=(
                                f"`{name}` was written in place by "
                                f"`{callee.name}` (line {call.lineno}) "
                                f"and is referenced afterwards")))
                        break
        # recurse into nested blocks
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                _check_block(index, fi, sub, wr, out)
        for h in getattr(stmt, "handlers", []) or []:
            _check_block(index, fi, h.body, wr, out)


def run(index: RepoIndex, files: list[ModuleFile]) -> list[Finding]:
    wr = _writing_map(index)
    wanted = {f.module for f in files}
    out: list[Finding] = []
    for fi in index.functions.values():
        if fi.mod.module not in wanted:
            continue
        # note: functions that *transitively* write (forwarding wrappers)
        # are still checked — a wrapper that reads its own parameter after
        # forwarding it to an in-place writer is exactly the bug
        _check_block(index, fi, fi.node.body, wr, out)
    return sorted(set(out))
