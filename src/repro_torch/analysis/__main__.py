"""CLI: ``python -m repro_torch.analysis`` (the port's wowlint).

Modes (the reference's flags):
  (default)            lint the surface, print findings, exit 0
  --fail-on-findings   exit 1 if any finding survives suppressions +
                       baseline (the CI gate)
  --pass NAME          run a single pass (repeatable)
  PATH [PATH...]       lint explicit files, scope filters bypassed
  --write-baseline     accept current findings into
                       wowlint_torch_baseline.json
  --list-passes        pass catalog
  --report-dead        surface modules unreachable from any entry point
  --compile-smoke      runtime capture-guard self-check on the card: a
                       tiny hop chunk is captured as a CUDA graph once
                       (cold count >= 1), then replayed (warm count 0);
                       raises without CUDA
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .engine import (
    BASELINE_PATH,
    LintEngine,
    lint_paths,
    report_dead,
    surface_files,
)
from .findings import load_baseline, save_baseline
from .passes import ALL_PASSES


def _compile_smoke() -> int:
    """Drive the port's own capture site: a 2-hop chunk of a 64-row index
    on the card through ``device_search._run_chunk`` three times — its
    first sight runs eagerly (and loads the kernel library), its second
    captures the graph, its third replays it."""
    import numpy as np
    import torch

    from .. import resolve_device
    from ..core import WoWIndex
    from ..core.device_search import (
        _init_state, _run_chunk, _run_hops, hop_cfg, to_device_index,
    )
    from ..core.snapshot import take_snapshot
    from .compile_guard import CaptureCounter

    dev = resolve_device(None)  # the card: raises without CUDA
    rng = np.random.default_rng(0)
    idx = WoWIndex(dim=8, m=4, ef_construction=16, seed=0)
    idx.insert_batch(rng.normal(size=(64, 8)).astype(np.float32),
                     np.arange(64, dtype=np.float64), batch_size=64)
    snap = take_snapshot(idx)
    di = to_device_index(snap, device=dev)
    cfg = hop_cfg(k=4, width=8, m=snap.m, o=snap.o, backend="cuda")
    q = torch.as_tensor(snap.vectors[:8], device=dev)
    r = torch.tensor([[0.0, 63.0]], device=dev).repeat(8, 1)
    st = _run_hops(di, _init_state(di, q, r, cfg), cfg, 1)  # the seed hop
    with CaptureCounter() as cold:
        _run_chunk(di, st, cfg, 2)  # first sight: eager
        _run_chunk(di, st, cfg, 2)  # second sight: captured
        torch.cuda.synchronize(dev)
    with CaptureCounter() as warm:
        _run_chunk(di, st, cfg, 2)  # replayed
        torch.cuda.synchronize(dev)
    ok = cold.count >= 1 and warm.count == 0
    print(f"compile-guard smoke: cold={cold.count} {cold.by_kind} "
          f"warm={warm.count} {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="wowlint", description=__doc__)
    ap.add_argument("paths", nargs="*", type=Path)
    ap.add_argument("--fail-on-findings", action="store_true")
    ap.add_argument("--pass", dest="passes", action="append", default=None,
                    metavar="NAME")
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--list-passes", action="store_true")
    ap.add_argument("--report-dead", action="store_true")
    ap.add_argument("--compile-smoke", action="store_true")
    args = ap.parse_args(argv)

    if args.list_passes:
        for p in ALL_PASSES:
            scope = p.SCOPE or "(whole surface)"
            print(f"{p.NAME:20s} {p.DESCRIPTION}  [scope: {scope}]")
        return 0
    if args.compile_smoke:
        return _compile_smoke()
    if args.report_dead:
        dead = report_dead()
        if dead:
            print("unreachable from any entry point:")
            for m in dead:
                print(f"  {m}")
        else:
            print("no dead modules in the lint surface")
        return 0

    if args.paths:
        findings = lint_paths(args.paths, passes=args.passes)
    else:
        findings = LintEngine(surface_files(), passes=args.passes).run()
        if not args.no_baseline:
            accepted = load_baseline(args.baseline)
            findings = [f for f in findings if f.key() not in accepted]

    if args.write_baseline:
        save_baseline(args.baseline, findings)
        print(f"baseline: {len(findings)} finding(s) -> {args.baseline}")
        return 0

    for f in findings:
        print(f.render())
    n = len(findings)
    nfiles = len({f.path for f in findings})
    if n:
        print(f"\n{n} finding(s) in {nfiles} file(s)")
    else:
        print("wowlint: clean")
    return 1 if (n and args.fail_on_findings) else 0


if __name__ == "__main__":
    sys.exit(main())
