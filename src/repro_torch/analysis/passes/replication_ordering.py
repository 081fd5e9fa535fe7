"""replication-ordering: quorum barrier before ack, strict epoch fences.

A copy of ``repro.analysis.passes.replication_ordering`` with the same
scope (its module regex matches the port's module names).

The replication layer's two lint-able contracts:

1. **Ack after the quorum barrier.**  In ``persist.replicate`` /
   ``serve.cluster``, an ack-named call (``ack``/``send_ack``/...) that
   is lexically reachable after a ``ship()`` but before the quorum
   barrier (``await_quorum``/``sync``) is a false-durability window: the
   client would learn "durable" while the record is only in flight.
   Statements walk in lexical order per function, mirroring the
   ``durability-ordering`` pass.

2. **Strict epoch comparisons.**  Epoch fencing is only sound when every
   comparison is strict: ``old <= new`` would let a deposed primary with
   an *equal* epoch through the fence (split-brain).  Any ``<=``/``>=``
   comparison whose operands mention an epoch (a name, attribute, or
   string subscript containing ``epoch``) is a finding — write ``<`` or
   ``>`` and make the tie rule explicit.
"""
from __future__ import annotations

import ast

from ..callgraph import FuncInfo, ModuleFile, RepoIndex, dotted
from ..findings import Finding

NAME = "replication-ordering"
DESCRIPTION = "ack before the quorum barrier, or a non-strict epoch compare"
SCOPE = r"persist\.replicate$|serve\.cluster$"

_SHIP_METHODS = {"ship", "replicate", "send_append"}
_BARRIER_METHODS = {"await_quorum", "sync", "fsync", "quorum_sync"}
_ACK_CALLS = {"ack", "send_ack", "_send_ack", "reply_ack", "ack_up_to",
              "set_result"}


def _mentions_epoch(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and "epoch" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "epoch" in sub.attr.lower():
            return True
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and "epoch" in sub.value.lower()):
            return True
    return False


class _AckChecker:
    """Lexical walk tracking shipped-but-not-quorum-synced records."""

    def __init__(self, fi: FuncInfo):
        self.fi = fi
        self.pending: dict[str, int] = {}  # receiver -> ship lineno
        self.out: list[Finding] = []

    def walk(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs own their own ordering discipline
        if isinstance(stmt, (ast.If, ast.For, ast.While, ast.With, ast.Try)):
            for header in ("test", "iter"):
                expr = getattr(stmt, header, None)
                if expr is not None:
                    self._scan(expr)
            for item in getattr(stmt, "items", []) or []:
                self._scan(item.context_expr)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    self.walk(sub)
            for h in getattr(stmt, "handlers", []) or []:
                self.walk(h.body)
            return
        self._scan(stmt)

    def _scan(self, node: ast.AST) -> None:
        for call in ast.walk(node):
            if not isinstance(call, ast.Call) or not isinstance(
                    call.func, ast.Attribute):
                continue
            meth = call.func.attr
            recv = dotted(call.func.value)
            if meth in _SHIP_METHODS and recv is not None:
                self.pending.setdefault(recv, call.lineno)
            elif meth in _BARRIER_METHODS:
                # any quorum/sync barrier settles everything in flight
                self.pending.clear()
            elif meth in _ACK_CALLS and self.pending:
                for recv2, line in sorted(self.pending.items()):
                    self.out.append(Finding(
                        pass_name=NAME, path=self.fi.mod.rel,
                        line=call.lineno,
                        message=(f"ack (`{meth}`) reachable before the "
                                 f"quorum barrier — `{recv2}.ship()` at "
                                 f"line {line} is not yet quorum-durable "
                                 f"(ship->quorum->ack)")))


def _epoch_findings(mf: ModuleFile) -> list[Finding]:
    out: list[Finding] = []
    for node in ast.walk(mf.tree):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, (ast.LtE, ast.GtE)) for op in node.ops):
            continue
        if any(_mentions_epoch(e)
               for e in [node.left, *node.comparators]):
            out.append(Finding(
                pass_name=NAME, path=mf.rel, line=node.lineno,
                message=("non-strict epoch comparison (`<=`/`>=`): fencing "
                         "must be strict (`<`/`>`) or an equal-epoch "
                         "deposed primary passes the fence")))
    return out


def run(index: RepoIndex, files: list[ModuleFile]) -> list[Finding]:
    wanted = {f.module for f in files}
    out: list[Finding] = []
    for mf in files:
        out.extend(_epoch_findings(mf))
    for fi in index.functions.values():
        if fi.mod.module not in wanted:
            continue
        c = _AckChecker(fi)
        c.walk(fi.node.body)
        out.extend(c.out)
    return sorted(set(out))
