"""durability-ordering: log -> fsync -> ack, never ack first.

A copy of ``repro.analysis.passes.durability`` with the same scope (its
module regex matches the port's module names).

The serve engine's ingest contract is that a client ack implies
the WAL record is on disk: ``append(..., fsync=False)`` group-commits
are only legal when a ``sync()`` barrier on the same WAL reaches disk
*before* the function returns or completes a request.  An ack that is
lexically reachable between the unfsynced append and its barrier is a
lost-write window — exactly the dropped-fsync chaos tests' failure
mode, but caught at lint time.

Per function (in ``persist/`` / ``serve/lifecycle`` / ``core/index``),
statements are walked in lexical order tracking the set of WAL
receivers with un-synced appends (``X.append(..., fsync=False)`` /
``X.log_insert(..., fsync=False)``).  A ``X.sync()`` / ``X.fsync()`` /
fsync-ing append clears ``X``; a ``return`` / ``yield`` or an ack-named
call (``ack/set_result/_finish/_complete``) while the pending set is
non-empty is a finding.
"""
from __future__ import annotations

import ast

from ..callgraph import FuncInfo, ModuleFile, RepoIndex, dotted
from ..findings import Finding

NAME = "durability-ordering"
DESCRIPTION = "ack/return reachable before the WAL fsync barrier"
SCOPE = r"persist\.|serve\.lifecycle$|core\.index$"

_APPEND_METHODS = {"append", "log_insert", "log_delete", "log_compact",
                   "log", "write_record"}
_SYNC_METHODS = {"sync", "fsync", "flush_and_sync"}
_ACK_CALLS = {"ack", "set_result", "_finish", "_complete", "set_exception"}


def _fsync_kw(call: ast.Call) -> bool | None:
    for kw in call.keywords:
        if kw.arg == "fsync" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return None


def _receiver(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Attribute):
        return dotted(call.func.value)
    return None


class _Checker:
    def __init__(self, fi: FuncInfo):
        self.fi = fi
        self.pending: dict[str, int] = {}  # receiver -> append lineno
        self.out: list[Finding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        for recv, line in sorted(self.pending.items()):
            self.out.append(Finding(
                pass_name=NAME, path=self.fi.mod.rel, line=node.lineno,
                message=(f"{what} reachable before `{recv}.sync()` — "
                         f"unfsynced append at line {line} "
                         f"(log->fsync->ack)")))

    def walk(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _calls(self, stmt: ast.stmt):
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                yield sub

    def _scan_calls(self, stmt: ast.stmt) -> None:
        for call in self._calls(stmt):
            if not isinstance(call.func, ast.Attribute):
                continue
            meth = call.func.attr
            recv = _receiver(call)
            if recv is None:
                continue
            if meth in _APPEND_METHODS:
                if _fsync_kw(call) is False:
                    self.pending.setdefault(recv, call.lineno)
                elif _fsync_kw(call) is True or _fsync_kw(call) is None:
                    # default fsync=True appends double as a barrier
                    self.pending.pop(recv, None)
            elif meth in _SYNC_METHODS:
                self.pending.pop(recv, None)
            elif meth in _ACK_CALLS and self.pending:
                self._flag(call, f"ack (`{meth}`)")

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.Return,)):
            self._scan_calls(stmt)
            if self.pending:
                self._flag(stmt, "`return`")
            return
        if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, (ast.Yield, ast.YieldFrom)):
            self._scan_calls(stmt)
            if self.pending:
                self._flag(stmt, "`yield`")
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs own their own WAL discipline
        if isinstance(stmt, (ast.If, ast.For, ast.While, ast.With, ast.Try)):
            # scan only the header expression (test/iter/context); body
            # statements are walked in order below, not double-scanned
            for header in ("test", "iter", "items"):
                expr = getattr(stmt, header, None)
                if expr is not None:
                    for e in (expr if isinstance(expr, list) else [expr]):
                        self._scan_calls(ast.Expr(value=getattr(
                            e, "context_expr", e)))
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    self.walk(sub)
            for h in getattr(stmt, "handlers", []) or []:
                self.walk(h.body)
            return
        self._scan_calls(stmt)


def run(index: RepoIndex, files: list[ModuleFile]) -> list[Finding]:
    wanted = {f.module for f in files}
    out: list[Finding] = []
    for fi in index.functions.values():
        if fi.mod.module not in wanted:
            continue
        c = _Checker(fi)
        c.walk(fi.node.body)
        out.extend(c.out)
    return sorted(set(out))
