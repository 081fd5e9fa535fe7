"""Lint engine: surface discovery, pass dispatch, suppression/baseline.

The port of ``repro.analysis.engine``.  The *lint surface* is
``src/repro_torch`` minus ``QUARANTINE`` — the reference's quarantine
rewritten to the port's module names: the LM stack (models, training
loop, architecture presets, attention/scan kernels).  It is exercised by
its own tests and the smoke, but it is not part of the WoW
serve/build/persist system, and its whole-model style would drown the
signal of the passes that exist to protect the index hot paths.  The
quarantine is an explicit list — shrinking it is the cleanup direction,
growing it needs a reason in review.
"""
from __future__ import annotations

import re
from pathlib import Path

from .callgraph import ModuleFile, RepoIndex, dead_modules, load_module_file
from .findings import (
    Finding,
    is_suppressed,
    load_baseline,
    parse_suppressions,
)
from .passes import ALL_PASSES, BY_NAME

# repo root = parents[3] of src/repro_torch/analysis/engine.py
REPO_ROOT = Path(__file__).resolve().parents[3]
SRC_ROOT = REPO_ROOT / "src"
BASELINE_PATH = REPO_ROOT / "wowlint_torch_baseline.json"

# the LM stack: outside the WoW serve/build/persist surface (see module
# docstring).  repro_torch.serve.engine stays *in* — calls into
# quarantined modules simply don't resolve.
QUARANTINE = (
    r"^repro_torch\.models(\.|$)",
    r"^repro_torch\.train(\.|$)",
    r"^repro_torch\.configs(\.|$)",
    r"^repro_torch\.parallel\.logical$",
    r"^repro_torch\.kernels\.(flash_attention|mamba_scan|rwkv6)$",
    r"^repro_torch\.launch\.(train|dryrun|mesh|report)$",
)
_QUAR_RE = [re.compile(p) for p in QUARANTINE]


def _module_name(path: Path) -> str:
    rel = path.resolve().relative_to(SRC_ROOT.resolve())
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def quarantined(module: str) -> bool:
    return any(r.search(module) for r in _QUAR_RE)


def surface_files(root: Path = SRC_ROOT / "repro_torch") -> list[ModuleFile]:
    out = []
    for path in sorted(root.rglob("*.py")):
        mod = _module_name(path)
        if quarantined(mod):
            continue
        out.append(load_module_file(path, mod, REPO_ROOT))
    return out


def entry_files() -> list[ModuleFile]:
    """Files whose imports root the reachability walk: the port's tests
    (``tests/test_torch_*.py``), ``chip_smoke.py``, the port's examples
    (``examples/*_torch.py``), the launchers and the package
    ``__main__`` modules."""
    paths = sorted((REPO_ROOT / "tests").glob("test_torch_*.py"))
    paths += sorted((REPO_ROOT / "examples").glob("*_torch.py"))
    paths += [p for p in [REPO_ROOT / "chip_smoke.py"] if p.exists()]
    out = [load_module_file(p, f"_entry.{p.stem}", REPO_ROOT) for p in paths]
    for path in sorted((SRC_ROOT / "repro_torch").rglob("*.py")):
        mod = _module_name(path)
        if mod.startswith("repro_torch.launch") or path.stem == "__main__":
            out.append(load_module_file(path, mod, REPO_ROOT))
    return out


class LintEngine:
    def __init__(self, files: list[ModuleFile],
                 passes: list[str] | None = None,
                 scope_filter: bool = True):
        self.files = files
        self.index = RepoIndex(files)
        names = passes or [p.NAME for p in ALL_PASSES]
        self.passes = [BY_NAME[n] for n in names]
        self.scope_filter = scope_filter

    def run(self) -> list[Finding]:
        findings: list[Finding] = []
        for p in self.passes:
            if self.scope_filter and p.SCOPE is not None:
                scope_re = re.compile(p.SCOPE)
                files = [f for f in self.files if scope_re.search(f.module)]
            else:
                files = self.files
            findings.extend(p.run(self.index, files))
        # inline suppressions
        sup = {f.rel: parse_suppressions(f.source) for f in self.files}
        return sorted(f for f in findings
                      if not is_suppressed(f, sup.get(f.path, {})))


def lint_repo(passes: list[str] | None = None,
              baseline: Path | None = BASELINE_PATH) -> list[Finding]:
    """Lint the full surface; baseline-accepted findings are filtered."""
    eng = LintEngine(surface_files(), passes=passes)
    findings = eng.run()
    if baseline is not None:
        accepted = load_baseline(baseline)
        findings = [f for f in findings if f.key() not in accepted]
    return findings


def lint_paths(paths: list[Path],
               passes: list[str] | None = None) -> list[Finding]:
    """Lint explicit files (fixtures, pre-commit): pass scoping is
    bypassed — every selected pass sees every given file."""
    files = []
    for i, p in enumerate(paths):
        p = Path(p)
        try:
            mod = _module_name(p)
        except ValueError:
            mod = f"_explicit.{p.stem}_{i}"
        files.append(load_module_file(p, mod, REPO_ROOT))
    return LintEngine(files, passes=passes, scope_filter=False).run()


def report_dead() -> list[str]:
    return dead_modules(surface_files(), entry_files())
