"""Findings, inline suppressions, and the committed baseline.

A finding is (pass, file, line, message).  Two escape hatches keep the
suite clean-or-fail in CI without blocking intentional exceptions:

- inline: a ``# wowlint: disable=pass-a,pass-b`` comment on the offending
  line (or ``disable=all``) suppresses matching passes for that line;
- baseline: ``wowlint_torch_baseline.json`` at the repo root records
  findings that are accepted as-is; anything in it is filtered from the
  failing set.  The shipped baseline is empty — the tree lints clean —
  but the mechanism is what lets a future change land a known finding
  incrementally.

A copy of ``repro.analysis.findings``: the port keeps its own.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

_SUPPRESS_RE = re.compile(r"#\s*wowlint:\s*disable=([\w,\-]+)")


@dataclass(frozen=True, order=True)
class Finding:
    pass_name: str
    path: str  # repo-relative, posix separators
    line: int
    message: str

    def key(self) -> str:
        return f"{self.pass_name}:{self.path}:{self.line}:{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"


def parse_suppressions(source: str) -> dict[int, set[str]]:
    """Map 1-indexed line number -> set of suppressed pass names."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {p.strip() for p in m.group(1).split(",") if p.strip()}
    return out


def is_suppressed(f: Finding, sup: dict[int, set[str]]) -> bool:
    names = sup.get(f.line)
    return bool(names) and (f.pass_name in names or "all" in names)


def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("findings", []))


def save_baseline(path: Path, findings: list[Finding]) -> None:
    payload = {
        "comment": "wowlint accepted-findings baseline; see ANALYSIS.md",
        "findings": sorted(f.key() for f in findings),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")
