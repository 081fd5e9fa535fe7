"""Render roofline tables from the port's dry-run records (the port of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os


def load(dirpath: str) -> dict[tuple[str, str], dict]:
    out = {}
    if not os.path.isdir(dirpath):
        return out
    for name in sorted(os.listdir(dirpath)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(dirpath, name)) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"])] = r
    return out


def _f(x, nd=3):
    if x is None:
        return "-"
    if isinstance(x, float):
        if x == 0:
            return "0"
        if abs(x) >= 1000 or abs(x) < 0.001:
            return f"{x:.2e}"
        return f"{x:.{nd}g}"
    return str(x)


def roofline_table(records: dict, opt_records: dict | None = None) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful-FLOPs ratio | dev mem GiB | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(records.items()):
        if r.get("skipped"):
            lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | SKIP: sub-quadratic only |")
            continue
        if r.get("error"):
            lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | ERROR |")
            continue
        t = r["terms"]
        note = ""
        if opt_records and (arch, shape) in opt_records:
            o = opt_records[(arch, shape)]
            if not o.get("skipped") and not o.get("error"):
                dom = t["bottleneck"]
                imp = t[dom] / max(o["terms"][dom], 1e-12)
                note = f"opt: dom term ÷{imp:.1f}"
        lines.append(
            f"| {arch} | {shape} | {_f(t['compute_s'])} | {_f(t['memory_s'])} | "
            f"{_f(t['collective_s'])} | {t['bottleneck'][:-2]} | "
            f"{_f(r.get('useful_flops_ratio'))} | "
            f"{r['memory']['total_bytes']/2**30:.1f} | {note} |"
        )
    return "\n".join(lines)


def summary(records: dict) -> dict:
    ok = [r for r in records.values() if not r.get("skipped") and not r.get("error")]
    sk = [r for r in records.values() if r.get("skipped")]
    er = [r for r in records.values() if r.get("error")]
    doms = {}
    for r in ok:
        doms[r["terms"]["bottleneck"]] = doms.get(r["terms"]["bottleneck"], 0) + 1
    return {"traced": len(ok), "skipped": len(sk), "errors": len(er),
            "dominant": doms}


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    out = []
    for mesh in ("single", "multi"):
        base_dir = os.path.join(args.dir, mesh)
        # classify: arch__shape.json = baseline, __opt = optimized tag,
        # anything else (__iterX, chunk sweeps) = iteration records.
        baseline, opt = {}, {}
        for name in sorted(os.listdir(base_dir)) if os.path.isdir(base_dir) else []:
            if not name.endswith(".json"):
                continue
            parts = name[:-5].split("__")
            if len(parts) == 2:
                target = baseline
            elif parts[-1] == "opt":
                target = opt
            else:
                continue  # iteration record
            with open(os.path.join(base_dir, name)) as f:
                r = json.load(f)
            target[(r["arch"], r["shape"])] = r
        out.append(f"\n## {mesh} mesh — baseline ({summary(baseline)})\n")
        out.append(roofline_table(baseline, opt))
        if opt:
            out.append(f"\n## {mesh} mesh — optimized ({summary(opt)})\n")
            out.append(roofline_table(opt))
    text = "\n".join(out)
    print(text)
    return text


if __name__ == "__main__":
    main()
