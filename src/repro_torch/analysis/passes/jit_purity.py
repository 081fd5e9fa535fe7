"""capture-purity: no host round-trips or Python control flow on tensors
inside a CUDA-graph capture or a kernel launch wrapper.

The port of ``repro.analysis.passes.jit_purity`` (pass ``jit-purity``).
Where JAX traces a jitted function once, the port captures a hop chunk
once as a CUDA graph and replays it (``core.device_search._GraphedChunk``).
A host sync inside the captured region (``.item()``, ``.cpu()``,
``float()`` of a tensor) raises under capture — or, where the same code
also runs eagerly, forces a device round-trip per call; a Python
``if``/``while``/``for`` over a tensor value reads it on the host and
bakes one branch into the graph; an op whose output size depends on the
data (``nonzero``, ``torch.unique``, boolean-mask indexing) syncs to size
its output.  This pass walks every function reachable from a graph or
kernel root (the traced set from the call graph) with a value-taint
analysis:

- root parameters are tainted unless static (``callgraph``: annotated
  with host data or a frozen config); callee parameter taint is
  propagated from actual call-site argument taint to a fixpoint;
- ``torch.*`` results are tainted (``torch.cuda.*`` host queries and
  ``torch.device``/``finfo``/``iinfo`` are not); ``.shape`` / ``.ndim`` /
  ``.dtype`` / ``.device`` / ``.is_cuda``, the metadata methods
  (``.numel()``, ``.dim()``, ``.size()``, ``.stride()``, ``.data_ptr()``,
  ``.is_contiguous()``, ``.element_size()``), ``is None`` comparisons and
  the host fields of a record (``HopState.t``) are static; a surface
  callee whose every return is static returns a static value; everything
  else propagates.

Findings: tainted args to ``float/int/bool/np.asarray/np.array``,
``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.nonzero()``/
``.unique()`` on tainted values, ``torch.nonzero``/``torch.unique``/
``torch.masked_select`` of tainted values, indexing by a tainted boolean
mask, and ``if``/``while``/``for``/ternary driven by a tainted expression
(a loop over a list or tuple of tensors is a loop over its static
length, not over a tensor).
"""
from __future__ import annotations

import ast

from ..callgraph import FuncInfo, ModuleFile, RepoIndex, dotted
from ..findings import Finding

NAME = "capture-purity"
DESCRIPTION = ("host round-trips / Python control flow on tensors inside "
               "CUDA-graph captures or kernel launch wrappers")
SCOPE = None  # whole surface; findings only fire inside traced functions

_TAINT_NAMESPACES = {"torch", "F"}
_HOST_TORCH = ("torch.cuda.", "torch.backends.")
_HOST_TORCH_CALLS = {"torch.device", "torch.finfo", "torch.iinfo"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "size"}
_STATIC_METHODS = {"numel", "dim", "size", "stride", "data_ptr",
                   "is_contiguous", "element_size"}
_BANNED_CALLS = {
    "float": "float() on a tensor forces a host sync",
    "int": "int() on a tensor forces a host sync",
    "bool": "bool() on a tensor forces a host sync",
    "np.asarray": "np.asarray on a tensor forces a host transfer",
    "np.array": "np.array on a tensor forces a host transfer",
    "np.ascontiguousarray":
        "np.ascontiguousarray on a tensor forces a host transfer",
    "torch.nonzero": "torch.nonzero sizes its output from the data "
                     "(a host sync)",
    "torch.unique": "torch.unique sizes its output from the data "
                    "(a host sync)",
    "torch.masked_select": "torch.masked_select sizes its output from the "
                           "data (a host sync)",
}
_BANNED_METHODS = {
    "item": ".item() on a tensor forces a host sync",
    "tolist": ".tolist() on a tensor forces a host transfer",
    "cpu": ".cpu() on a tensor forces a host transfer",
    "numpy": ".numpy() on a tensor forces a host transfer",
    "nonzero": ".nonzero() sizes its output from the data (a host sync)",
    "unique": ".unique() sizes its output from the data (a host sync)",
    "masked_select": ".masked_select() sizes its output from the data "
                     "(a host sync)",
}
_BOOL_OPS = (ast.BitAnd, ast.BitOr, ast.BitXor)


class _Walker:
    """One local taint walk over a traced function body."""

    def __init__(self, index: RepoIndex, fi: FuncInfo,
                 tainted_params: set[str], traced: dict[str, FuncInfo],
                 static_returns: dict[str, bool]):
        self.index = index
        self.fi = fi
        self.traced = traced
        self.static_returns = static_returns
        self.env: dict[str, bool] = {p: (p in tainted_params)
                                     for p in fi.params}
        self.masks: set[str] = set()  # names bound to tainted bool tensors
        self.seqs: set[str] = set()  # names bound to list/tuple displays
        self.callee_taint: dict[str, set[str]] = {}
        self.findings: list[Finding] = []
        self.collect = False
        self.ret_taint = False

    # ----------------------------------------------------------- taint
    def tt(self, node: ast.AST) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return self.env.get(node.id, False)
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if (node.attr in _STATIC_ATTRS
                    or node.attr in self.index.static_fields):
                return False
            return self.tt(node.value)
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        if isinstance(node, ast.Compare):
            if all(isinstance(c, (ast.Is, ast.IsNot)) for c in node.ops):
                return False
            return self.tt(node.left) or any(self.tt(c)
                                             for c in node.comparators)
        if isinstance(node, (ast.BinOp,)):
            return self.tt(node.left) or self.tt(node.right)
        if isinstance(node, ast.BoolOp):
            return any(self.tt(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return self.tt(node.operand)
        if isinstance(node, ast.IfExp):
            if self.collect and self.tt(node.test):
                self._flag(node, "ternary on a tensor (use torch.where)")
            return self.tt(node.body) or self.tt(node.orelse)
        if isinstance(node, ast.Subscript):
            if self.collect and self._is_mask_index(node.slice):
                self._flag(node, "boolean-mask indexing sizes its output "
                                 "from the data (use masked_fill/where)")
            return self.tt(node.value) or self.tt(node.slice)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tt(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.tt(v) for v in node.values if v is not None)
        if isinstance(node, ast.Starred):
            return self.tt(node.value)
        if isinstance(node, ast.Slice):
            return any(self.tt(p) for p in
                       (node.lower, node.upper, node.step))
        return False

    def _is_mask(self, node: ast.AST) -> bool:
        """A tainted boolean tensor: a comparison, its negation or a
        logical combination, or a name bound to one."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return (not all(isinstance(c, (ast.Is, ast.IsNot))
                            for c in node.ops)) and self.tt(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, _BOOL_OPS):
            return self._is_mask(node.left) or self._is_mask(node.right)
        return False

    def _is_mask_index(self, sl: ast.AST) -> bool:
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        return any(self._is_mask(e) for e in elts)

    def _call_taint(self, node: ast.Call) -> bool:
        d = dotted(node.func)
        args_tainted = (any(self.tt(a) for a in node.args)
                        or any(self.tt(k.value) for k in node.keywords))
        if d is not None:
            head = d.split(".")[0]
            if d.startswith(_HOST_TORCH) or d in _HOST_TORCH_CALLS:
                return False
            if self.collect:
                self._check_banned(node, d, args_tainted)
            if head in _TAINT_NAMESPACES:
                return True
        # method call on a value: x.float(), st._replace(...)
        if isinstance(node.func, ast.Attribute):
            base_t = self.tt(node.func.value)
            if node.func.attr in _STATIC_METHODS:
                return False
            if self.collect and base_t and node.func.attr in _BANNED_METHODS:
                self._flag(node, _BANNED_METHODS[node.func.attr])
            callee = self.index.resolve_call(self.fi.mod, node.func,
                                             self.fi.cls)
            if callee is not None:
                self._record_callsite(node, callee)
                if self.static_returns.get(callee.qualname):
                    return False
                return args_tainted or base_t
            return base_t or args_tainted
        callee = self.index.resolve_call(self.fi.mod, node.func, self.fi.cls)
        if callee is not None:
            self._record_callsite(node, callee)
            if self.static_returns.get(callee.qualname):
                return False
            return args_tainted
        if d in ("len", "range", "isinstance", "getattr", "hasattr", "min",
                 "max", "abs", "sum", "tuple", "list", "enumerate", "zip"):
            return args_tainted and d in ("min", "max", "abs", "sum",
                                          "tuple", "list")
        return args_tainted

    def _check_banned(self, node: ast.Call, d: str, args_tainted: bool):
        if d in _BANNED_CALLS and args_tainted:
            self._flag(node, _BANNED_CALLS[d])

    def _record_callsite(self, node: ast.Call, callee: FuncInfo) -> None:
        if callee.qualname not in self.traced:
            return
        params = callee.params
        offset = (1 if params and params[0] == "self"
                  and isinstance(node.func, ast.Attribute) else 0)
        tset = self.callee_taint.setdefault(callee.qualname, set())
        for i, a in enumerate(node.args):
            pi = i + offset
            if pi < len(params) and self.tt(a):
                tset.add(params[pi])
        for kw in node.keywords:
            if kw.arg is not None and kw.arg in params and self.tt(kw.value):
                tset.add(kw.arg)

    # ------------------------------------------------------- statements
    def _flag(self, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            pass_name=NAME, path=self.fi.mod.rel, line=node.lineno,
            message=f"{msg} (in traced `{self.fi.name}`)"))

    def _assign(self, target: ast.AST, tainted: bool,
                value: ast.AST | None = None) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = tainted
            if value is not None and self._is_mask(value):
                self.masks.add(target.id)
            else:
                self.masks.discard(target.id)
            if isinstance(value, (ast.List, ast.Tuple)) or (
                    isinstance(value, ast.BinOp)
                    and isinstance(value.left, (ast.List, ast.Tuple))):
                self.seqs.add(target.id)
            else:
                self.seqs.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._assign(e, tainted)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, tainted)
        # attribute/subscript stores: no local binding to update

    def _is_seq(self, node: ast.AST) -> bool:
        """A list/tuple display (or a name bound to one): iterating it
        runs a static number of times whatever tensors it holds."""
        if isinstance(node, (ast.List, ast.Tuple)):
            return True
        return isinstance(node, ast.Name) and node.id in self.seqs

    def run_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self.visit_stmt(stmt)

    def visit_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.Assign,)):
            t = self.tt(stmt.value)
            for tgt in stmt.targets:
                self._assign(tgt, t, stmt.value)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign(stmt.target, self.tt(stmt.value), stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            t = self.tt(stmt.value) or self.tt(stmt.target)
            self._assign(stmt.target, t)
        elif isinstance(stmt, ast.Expr):
            self.tt(stmt.value)
        elif isinstance(stmt, ast.Return):
            self.ret_taint |= self.tt(stmt.value)
        elif isinstance(stmt, ast.If):
            if self.collect and self.tt(stmt.test):
                self._flag(stmt, "`if` on a tensor (use torch.where)")
            self.run_body(stmt.body)
            self.run_body(stmt.orelse)
        elif isinstance(stmt, ast.While):
            if self.collect and self.tt(stmt.test):
                self._flag(stmt, "`while` on a tensor (a host sync per "
                                 "iteration)")
            self.run_body(stmt.body)
            self.run_body(stmt.orelse)
        elif isinstance(stmt, ast.For):
            it_t = self.tt(stmt.iter)
            if self.collect and it_t and not self._is_seq(stmt.iter):
                self._flag(stmt, "Python loop over a tensor (a host sync "
                                 "per element)")
            self._assign(stmt.target, it_t)
            self.run_body(stmt.body)
            self.run_body(stmt.orelse)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                t = self.tt(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, t)
            self.run_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.run_body(stmt.body)
            for h in stmt.handlers:
                self.run_body(h.body)
            self.run_body(stmt.orelse)
            self.run_body(stmt.finalbody)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass  # nested defs are walked via the traced set, not inline
        elif isinstance(stmt, ast.Assert):
            self.tt(stmt.test)
        # raise/pass/import/global: no taint flow


def _walk(index: RepoIndex, fi: FuncInfo, tainted: set[str],
          traced: dict[str, FuncInfo], static_returns: dict[str, bool],
          collect: bool) -> _Walker:
    w = _Walker(index, fi, tainted, traced, static_returns)
    # pass 1 stabilizes the local env (handles use-before-def in loops),
    # pass 2 optionally collects findings
    w.run_body(fi.node.body)
    w.collect = collect
    w.findings.clear()
    w.callee_taint.clear()
    w.ret_taint = False
    w.run_body(fi.node.body)
    return w


def _static_returns(index: RepoIndex,
                    traced: dict[str, FuncInfo]) -> dict[str, bool]:
    """Traced functions whose every return is static with every
    non-static parameter tainted (``ops._use_kernel`` returns
    ``t.is_cuda``): a call of one is static whatever its arguments."""
    out: dict[str, bool] = {}
    for _ in range(4):  # a caller may precede its callee: settle to a fixpoint
        before = dict(out)
        for q, fi in traced.items():
            has_return = any(isinstance(n, ast.Return)
                             and n.value is not None
                             for n in ast.walk(fi.node))
            tainted = {p for p in fi.params if p not in ("self", "cls")
                       and not index.static_annotation(
                           fi.annotations.get(p))}
            w = _walk(index, fi, tainted, traced, out, collect=False)
            out[q] = has_return and not w.ret_taint
        if out == before:
            break
    return out


def run(index: RepoIndex, files: list[ModuleFile]) -> list[Finding]:
    traced = index.traced_functions()
    static_returns = _static_returns(index, traced)
    taint: dict[str, set[str]] = {}
    for q, fi in traced.items():
        if fi.root:
            taint[q] = {p for p in fi.params
                        if p not in fi.static_params and p != "self"}
        else:
            taint[q] = set()
    # interprocedural fixpoint: call-site arg taint -> callee param taint
    for _ in range(24):
        changed = False
        for q, fi in traced.items():
            w = _walk(index, fi, taint[q], traced, static_returns,
                      collect=False)
            for callee_q, params in w.callee_taint.items():
                if not params <= taint[callee_q]:
                    taint[callee_q] |= params
                    changed = True
        if not changed:
            break
    wanted = {f.module for f in files}
    out: list[Finding] = []
    for q, fi in traced.items():
        if fi.mod.module not in wanted:
            continue
        w = _walk(index, fi, taint[q], traced, static_returns, collect=True)
        out.extend(w.findings)
    return sorted(set(out))
