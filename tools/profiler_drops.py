#!/usr/bin/env python3
"""Count the device records that ``torch.profiler`` drops, session by
session, with and without ``chip_smoke.py``'s prelude.

    python3 tools/profiler_drops.py [--sessions 12]

Needs one card.  Every session traces the same run in one process: R
replays of a captured one-kernel CUDA graph, each followed by F tiny
eager kernels and a 0.3 ms host gap, so the run's kernel records are
known (R x (F + 1)).  Even sessions are bare profiler sessions: each
kernel launch (``cudaLaunchKernel`` or ``cudaGraphLaunch``) is linked to
its kernel record by correlation id, and the launches left without one
are printed by their index in launch order.  Odd sessions go through
``chip_smoke._trace``, which opens the session with its prelude of spin
kernels: they print how many prelude records were lost and whether every
record of the run was kept.  One JSON line a session, then a summary;
the exit code is 1 if a prelude session lost a record of the run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

R, F, GAP_S = 480, 150, 3e-4


def _graph_and_run():
    z = torch.ones(64, device="cuda")
    y = torch.ones(64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            y.mul_(1.0000001)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y.mul_(1.0000001)
    torch.cuda.synchronize()

    def run():
        for _ in range(R):
            g.replay()
            for _ in range(F):
                torch.neg(z, out=z)
            time.sleep(GAP_S)
        torch.cuda.synchronize()

    return run


def _events(path: str) -> list:
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    os.remove(path)
    return [e for e in ev if e.get("ph") == "X"]


def bare(run, i: int, outdir: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    path = os.path.join(outdir, f"profiler_drops_{i}.json")
    prof.export_chrome_trace(path)
    ev = _events(path)
    kept = {e["args"].get("correlation") for e in ev
            if e.get("cat") == "kernel"}
    launches = sorted((e for e in ev if e.get("cat") == "cuda_runtime"
                       and e["name"] in ("cudaLaunchKernel",
                                         "cudaGraphLaunch")),
                      key=lambda e: float(e["ts"]))
    lost = [j for j, e in enumerate(launches)
            if e["args"].get("correlation") not in kept]
    return {"session": i, "prelude": False, "launches": len(launches),
            "lost": len(lost), "lost_launch_indices": lost[:32]}


def with_prelude(run, i: int, outdir: str) -> dict:
    import chip_smoke

    tr = chip_smoke._trace(run, f"profiler_drops_{i}")
    ev = _events(os.path.join(outdir, f"profiler_drops_{i}_trace.json"))
    spins = sum(e.get("cat") == "kernel" and "spin_kernel" in e["name"]
                for e in ev)
    return {"session": i, "prelude": True, "run_records": tr["ops"],
            "expected": R * (F + 1), "kept_all": tr["ops"] == R * (F + 1),
            "prelude_lost": chip_smoke.PRELUDE - spins}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_drops: needs a card", file=sys.stderr)
        return 1
    outdir = os.path.join(os.path.dirname(HERE), "build")
    os.makedirs(outdir, exist_ok=True)
    run = _graph_and_run()
    rows = []
    for i in range(args.sessions):
        row = (with_prelude if i % 2 else bare)(run, i, outdir)
        print(json.dumps(row), flush=True)
        rows.append(row)
    bad = [r["session"] for r in rows if r["prelude"] and not r["kept_all"]]
    print(json.dumps({
        "bare_lost": [r["lost"] for r in rows if not r["prelude"]],
        "prelude_lost": [r["prelude_lost"] for r in rows if r["prelude"]],
        "prelude_sessions_with_run_records_lost": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
