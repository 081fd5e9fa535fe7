"""AST module index, capture and kernel roots, call graph, reachability.

The port of ``repro.analysis.callgraph``: the same AST index, import and
call resolution, traced set and dead-module walk, with the port's own
boundaries as roots.  It answers three questions about the lint surface
without importing any of it:

1. *Which functions are roots?*  Where the JAX package traces a function
   under ``jax.jit`` or hands it to ``pl.pallas_call``, the port runs it
   under a CUDA-graph capture or launches a hand-written kernel:

   - **graph roots**: every function called inside a ``with
     torch.cuda.graph(...)`` block (``_GraphedChunk.__init__`` calling
     ``_hop_body`` in ``core.device_search``): its ops are recorded once
     and replayed, so a host sync breaks the capture and a Python branch
     on a tensor bakes one side into the graph;
   - **kernel roots**: every function that launches a ``csrc`` library
     through ``kernels._build.load``, the launch wrappers of the CUDA
     kernels (the counterpart of the Pallas kernels).

   A root's parameters are tensors unless annotated otherwise: a
   parameter annotated ``int``/``float``/``str``/``bool`` (or a tuple of
   them), a numpy array, or a frozen config (a ``NamedTuple`` or frozen
   dataclass whose fields hold no tensor, such as ``HopCfg``) is static.
2. *Which functions are traced?*  The transitive callees of the roots,
   resolved through local defs, ``from x import y`` aliases, module
   aliases, and ``self.`` method calls — the set the capture-purity pass
   walks.  Resolution never crosses into quarantined modules.
3. *Which modules are dead?*  An import graph over ``repro_torch.*``
   (including module names spelled in string literals: subprocess test
   scripts build import statements in strings, and a pure-AST walk would
   report their targets as false corpses) walked from the entry points.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

_STR_MODULE_RE = re.compile(r"\brepro_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+")
_HOST_TYPES = {"int", "float", "str", "bool", "None", "tuple", "Tuple",
               "ndarray", "np.ndarray"}


def dotted(node: ast.AST) -> str | None:
    """Render a Name/Attribute chain as 'a.b.c' (None for anything else)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class ModuleFile:
    path: Path
    module: str  # dotted module name ("repro_torch.core.device_search")
    source: str
    tree: ast.Module
    rel: str  # repo-relative posix path for findings
    is_pkg: bool = False  # __init__.py (relative imports resolve deeper)


@dataclass
class FuncInfo:
    mod: ModuleFile
    qualname: str  # "module:Class.name" or "module:name"
    name: str
    cls: str | None
    node: ast.FunctionDef
    params: list[str] = field(default_factory=list)
    annotations: dict[str, str] = field(default_factory=dict)
    root: bool = False
    root_kind: str | None = None  # "graph" | "kernel"
    static_params: set[str] = field(default_factory=set)


def load_module_file(path: Path, module: str, repo_root: Path) -> ModuleFile:
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    try:
        rel = path.resolve().relative_to(repo_root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    return ModuleFile(path=path, module=module, source=source, tree=tree,
                      rel=rel, is_pkg=path.name == "__init__.py")


def _is_graph_ctx(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(...)`` (any alias ending in ``cuda.graph``)."""
    expr = item.context_expr
    if not isinstance(expr, ast.Call):
        return False
    d = dotted(expr.func)
    return d is not None and (d == "graph" or d.endswith("cuda.graph"))


def _record_class(node: ast.ClassDef) -> dict[str, str] | None:
    """Field -> annotation of a ``NamedTuple`` or frozen dataclass (None
    for any other class)."""
    named = any((dotted(b) or "").endswith("NamedTuple") for b in node.bases)
    frozen = False
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call) and (dotted(dec.func) or "").endswith(
                "dataclass"):
            frozen = any(kw.arg == "frozen" and isinstance(
                kw.value, ast.Constant) and kw.value.value is True
                for kw in dec.keywords)
    if not (named or frozen):
        return None
    return {item.target.id: ast.unparse(item.annotation)
            for item in node.body
            if isinstance(item, ast.AnnAssign)
            and isinstance(item.target, ast.Name)}


class RepoIndex:
    """Parsed lint surface: functions, imports, call resolution."""

    def __init__(self, files: list[ModuleFile]):
        self.files = files
        self.by_module: dict[str, ModuleFile] = {f.module: f for f in files}
        self.functions: dict[str, FuncInfo] = {}
        # per-module name tables
        self._locals: dict[str, dict[str, str]] = {}  # mod -> name -> qual
        self._methods: dict[str, dict[str, dict[str, str]]] = {}
        self._imports: dict[str, dict[str, tuple[str, str | None]]] = {}
        # NamedTuple / frozen dataclass fields across the surface
        self._records: dict[str, dict[str, str]] = {}
        for f in files:
            self._index_module(f)
        tensor_fields = {n for fields in self._records.values()
                         for n, ann in fields.items() if "Tensor" in ann}
        #: classes whose every field is host data (``HopCfg``): a
        #: parameter annotated with one is static
        self.config_classes = {
            c for c, fields in self._records.items()
            if fields and all(self.host_annotation(a)
                              for a in fields.values())}
        #: record fields annotated with host data and never with a tensor
        #: (``HopState.t``): reading one off a tensor record is static
        self.static_fields = {
            n for fields in self._records.values()
            for n, ann in fields.items()
            if self.host_annotation(ann)} - tensor_fields
        for f in files:
            self._detect_roots(f)

    @staticmethod
    def host_annotation(ann: str | None) -> bool:
        """An annotation naming host data only (no tensor)."""
        if not ann or "Tensor" in ann:
            return False
        names = re.findall(r"[A-Za-z_][A-Za-z0-9_.]*", ann)
        return bool(names) and all(n in _HOST_TYPES for n in names)

    # ------------------------------------------------------------ indexing
    def _index_module(self, mf: ModuleFile) -> None:
        locs: dict[str, str] = {}
        meths: dict[str, dict[str, str]] = {}
        imps: dict[str, tuple[str, str | None]] = {}
        self._locals[mf.module] = locs
        self._methods[mf.module] = meths
        self._imports[mf.module] = imps

        def add_func(node: ast.FunctionDef, cls: str | None) -> FuncInfo:
            qual = (f"{mf.module}:{cls}.{node.name}" if cls
                    else f"{mf.module}:{node.name}")
            args = node.args.posonlyargs + node.args.args
            params = [a.arg for a in args]
            anns = {a.arg: ast.unparse(a.annotation)
                    for a in args + node.args.kwonlyargs
                    if a.annotation is not None}
            params += [a.arg for a in node.args.kwonlyargs]
            fi = FuncInfo(mod=mf, qualname=qual, name=node.name, cls=cls,
                          node=node, params=params, annotations=anns)
            self.functions[qual] = fi
            return fi

        for node in mf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = add_func(node, None)
                locs[node.name] = fi.qualname
                # nested defs are indexed too, so a capture of a
                # closure-local function still resolves
                for sub in ast.walk(node):
                    if sub is not node and isinstance(sub, ast.FunctionDef):
                        add_func(sub, None)
            elif isinstance(node, ast.ClassDef):
                table: dict[str, str] = {}
                meths[node.name] = table
                fields = _record_class(node)
                if fields is not None:
                    self._records[node.name] = fields
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        fi = add_func(item, node.name)
                        table[item.name] = fi.qualname
                        for sub in ast.walk(item):
                            if sub is not item and isinstance(
                                    sub, ast.FunctionDef):
                                add_func(sub, node.name)
            elif isinstance(node, ast.ImportFrom):
                target = self._resolve_from(mf.module, node, mf.is_pkg)
                if target:
                    for alias in node.names:
                        imps[alias.asname or alias.name] = (
                            target, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    imps[alias.asname or alias.name] = (alias.name, None)

    @staticmethod
    def _resolve_from(module: str, node: ast.ImportFrom,
                      is_pkg: bool = False) -> str | None:
        if node.level == 0:
            return node.module
        parts = module.split(".")
        # level 1 = current package: the module's parent — except for a
        # package __init__, whose "current package" is itself
        level = node.level - 1 if is_pkg else node.level
        base = parts[: len(parts) - level]
        if not base:
            return None
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)

    # ------------------------------------------------------- root detection
    def _apply_root(self, fi: FuncInfo, kind: str) -> None:
        fi.root = True
        fi.root_kind = fi.root_kind or kind
        fi.static_params.update(
            p for p in fi.params
            if p in ("self", "cls") or self.static_annotation(
                fi.annotations.get(p)))

    def static_annotation(self, ann: str | None) -> bool:
        """A parameter annotation that makes the parameter static."""
        if ann is None:
            return False
        return self.host_annotation(ann) or ann in self.config_classes

    def _is_kernel_load(self, mf: ModuleFile, call: ast.Call,
                        cls: str | None) -> bool:
        """A call of ``kernels._build.load`` (resolved, or spelled
        ``_build.load`` where ``_build`` is outside the surface)."""
        callee = self.resolve_call(mf, call.func, cls)
        if callee is not None:
            return (callee.name == "load"
                    and callee.mod.module.endswith("kernels._build"))
        d = dotted(call.func)
        return d is not None and d.endswith("_build.load")

    def _detect_roots(self, mf: ModuleFile) -> None:
        for fi in [f for f in self.functions.values() if f.mod is mf]:
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call) and self._is_kernel_load(
                        mf, node, fi.cls):
                    self._apply_root(fi, "kernel")
                if not (isinstance(node, ast.With)
                        and any(_is_graph_ctx(i) for i in node.items)):
                    continue
                for stmt in node.body:
                    for call in ast.walk(stmt):
                        if not isinstance(call, ast.Call):
                            continue
                        tfi = self.resolve_call(mf, call.func, fi.cls)
                        if tfi is not None:
                            self._apply_root(tfi, "graph")

    # ------------------------------------------------------ call resolution
    def resolve_call(self, mf: ModuleFile, func: ast.AST,
                     cls: str | None) -> FuncInfo | None:
        """Resolve a call's callee to a surface FuncInfo, or None."""
        d = dotted(func)
        if d is None:
            return None
        parts = d.split(".")
        locs = self._locals[mf.module]
        imps = self._imports[mf.module]
        if len(parts) == 1:
            name = parts[0]
            if name in locs:
                return self.functions[locs[name]]
            if name in imps:
                src_mod, src_name = imps[name]
                return self._lookup(src_mod, src_name or name)
            # nested def in an enclosing function of this module
            qual = f"{mf.module}:{name}"
            return self.functions.get(qual)
        if parts[0] == "self" and len(parts) == 2 and cls is not None:
            table = self._methods[mf.module].get(cls, {})
            if parts[1] in table:
                return self.functions[table[parts[1]]]
            return None
        # module-alias call: alias.name(...)
        head = parts[0]
        if head in imps:
            src_mod, src_name = imps[head]
            base = src_mod if src_name is None else f"{src_mod}.{src_name}"
            return self._lookup(base, parts[-1]) if len(parts) == 2 else None
        return None

    def _lookup(self, module: str, name: str) -> FuncInfo | None:
        if module not in self.by_module:
            return None
        qual = self._locals[module].get(name)
        if qual:
            return self.functions[qual]
        return None

    # ---------------------------------------------------------- traced set
    def traced_functions(self) -> dict[str, FuncInfo]:
        """Roots plus their transitive surface callees."""
        seen: dict[str, FuncInfo] = {}
        stack = [f for f in self.functions.values() if f.root]
        for f in stack:
            seen[f.qualname] = f
        while stack:
            fi = stack.pop()
            for call in (n for n in ast.walk(fi.node)
                         if isinstance(n, ast.Call)):
                callee = self.resolve_call(fi.mod, call.func, fi.cls)
                if callee is not None and callee.qualname not in seen:
                    seen[callee.qualname] = callee
                    stack.append(callee)
        return seen


# ----------------------------------------------------------- dead modules
def module_imports(mf: ModuleFile) -> set[str]:
    """repro_torch.* modules referenced by ``mf`` — AST imports plus
    module names spelled inside string literals (subprocess test
    scripts)."""
    out: set[str] = set()
    for node in ast.walk(mf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("repro_torch"):
                    out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            base = RepoIndex._resolve_from(mf.module, node, mf.is_pkg)
            if base and base.startswith("repro_torch"):
                out.add(base)
                for alias in node.names:
                    out.add(f"{base}.{alias.name}")
    out.update(_STR_MODULE_RE.findall(mf.source))
    return out


def dead_modules(surface: list[ModuleFile],
                 entry_files: list[ModuleFile]) -> list[str]:
    """Surface modules unreachable from any entry file's import closure."""
    known = {f.module for f in surface}

    # package __init__ reachability: importing repro_torch.core.x imports
    # repro_torch.core and repro_torch first
    def expand(mod: str) -> set[str]:
        parts = mod.split(".")
        return {".".join(parts[:i]) for i in range(1, len(parts) + 1)}

    reached: set[str] = set()
    frontier: list[str] = []
    for ef in entry_files:
        # an entry file that is itself a surface module (launchers,
        # __main__) is alive by definition
        if ef.module in known and ef.module not in reached:
            reached.add(ef.module)
            frontier.append(ef.module)
        for mod in module_imports(ef):
            for m in expand(mod):
                if m in known and m not in reached:
                    reached.add(m)
                    frontier.append(m)
    by_mod = {f.module: f for f in surface}
    while frontier:
        mod = frontier.pop()
        for dep in module_imports(by_mod[mod]):
            for m in expand(dep):
                if m in known and m not in reached:
                    reached.add(m)
                    frontier.append(m)
    return sorted(known - reached)
