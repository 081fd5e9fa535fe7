#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of WoW (``src/repro_torch``) on one NVIDIA card
and check it end to end.

    python3 chip_smoke.py

Phases (no failure is caught; any failed check exits non-zero):

  1. build — every CUDA source under ``src/repro_torch/csrc`` is compiled by
     ``nvcc`` (all started together), with its ptxas report;
  2. serve (the main path) — ``repro_torch.launch.serve.main`` builds a
     32,768-vector d = 128 index on the host (m = 16, ef_construction = 64,
     o = 4) and serves 256 queries of the paper's mixed workload (in-range
     fractions 2^-10 .. 2^0) on the card, k = 10, width = 64, for vec_dtype
     {f32, int8, bf16} x visited {bitmap, hash} x compact {none, (8, 8)},
     each through the CUDA kernel and through the plain torch version.
     Checks per configuration: the kernel's launch counter rose (counters
     are zeroed just before this phase and read just after it); kernel and
     plain runs agree under the tie rule (``compare_results``: ids, DC and
     hops equal, dists within 1e-5 of the terms, differing queries only as
     tie flips, at most 2%); f32 recall@10 >= 0.90; int8 within 0.03 and
     bf16 within 0.01 of f32;
  3. trace — ``torch.profiler`` over one warm f32 bitmap batch: device busy
     time (union of kernel/copy spans), wall time, the device's idle share
     and the top kernels (trace in ``build/serve_trace.json``);
  4. kernels — each kernel against its plain version on the card at the
     serving shapes (B in {8, 256}, K = 17, D = 128, n = 32,768) and at a
     deployment-size table (n = 2^21 rows x D = 128, 1 GiB in f32; B = 128,
     K = 48), in f32/bf16/int8, tolerance rtol 1e-5 + atol 1e-5*|v|*|q|;
     median time per launch (CUDA events over 20 launches, 5 rounds, after
     warm-up, a fresh id set per launch) beside the plain version's and the
     bound (bytes this run's ids need over 3.35 TB/s, or flops over 67
     TFLOP/s f32, whichever is larger);
  5. report — the kernels JSON line, then the ok line last.

Needs one card; exits non-zero without CUDA or outside a checkout of the
repository, before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
TIE_FLIP_SHARE = 0.02


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.time()
    names = _build.build_all()
    print(f"built {names} in {time.time() - t0:.2f}s")
    for name, log in _build.BUILD_LOG.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")


def phase_serve(launches: dict) -> dict:
    from repro_torch.core.device_search import compare_results
    from repro_torch.launch import serve

    args = ["--n", "32768", "--dim", "128", "--queries", "256", "--k", "10",
            "--width", "64", "--m", "16", "--ef-construction", "64",
            "--o", "4", "--vec-dtype", "f32", "int8", "bf16",
            "--visited", "bitmap", "hash", "--compact", "none", "8,8",
            "--backend", "cuda", "ref", "--device", "cuda"]
    for key in launches:
        launches[key] = 0
    out = serve.main(args)
    main_path = dict(launches)
    snap, wl = out["snapshot"], out["workload"]
    scale = float(snap.sq_norms.max() + (wl.queries**2).sum(1).max())
    runs = {(r["vec_dtype"], r["visited"], r["compact"], r["backend"]): r
            for r in out["runs"]}
    for (vd, vis, comp, backend), run in runs.items():
        if backend != "cuda":
            continue
        tag = f"{vd}/{vis}/compact={comp}"
        if run["launches"] <= 0:
            fail(f"{tag}: gather_norm_dot was never launched")
        plain = runs[(vd, vis, comp, "ref")]
        rep = compare_results(run["result"], plain["result"], scale=scale)
        if rep["faults"] or len(rep["tie_flips"]) > TIE_FLIP_SHARE * 256:
            fail(f"{tag}: kernel vs plain results {rep}")
        f32 = runs[("f32", vis, comp, "cuda")]["recall"]
        if vd == "f32" and run["recall"] < 0.90:
            fail(f"{tag}: f32 recall@10 {run['recall']:.4f} < 0.90")
        tol = {"f32": 0.0, "int8": 0.03, "bf16": 0.01}[vd]
        if run["recall"] < f32 - tol:
            fail(f"{tag}: recall {run['recall']:.4f} more than {tol} "
                 f"below f32 {f32:.4f}")
        print(f"ok {tag}: recall@10 {run['recall']:.4f}, "
              f"{run['qps']:.1f} QPS (plain {plain['qps']:.1f}), hops "
              f"p50 {run['hops_p50']:.0f} p99 {run['hops_p99']:.0f}, "
              f"launches {run['launches']}, tie flips "
              f"{len(rep['tie_flips'])}")
    print(f"main-path launches: {main_path}")
    return {"launches": main_path, "out": out}


def phase_trace(out: dict) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.device_search import (
        device_search, pad_queries, to_device_index,
    )

    snap, wl = out["snapshot"], out["workload"]
    di = to_device_index(snap, vec_dtype="f32", device="cuda")
    q, r = pad_queries(torch.as_tensor(wl.queries, device="cuda"),
                       torch.as_tensor(wl.ranges, dtype=torch.float32,
                                       device="cuda"))

    def batch():
        return device_search(di, q, r, k=10, width=64, m=snap.m, o=snap.o,
                             backend="cuda")

    batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        wall = time.perf_counter() - t0
    outdir = os.path.join(HERE, "build")  # tens of MB: kept out of git
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "serve_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    dev = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        print(f"trace: wall {wall * 1e3:.1f} ms; device time not measured "
              "(the profiler recorded no device activity)")
        return
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, end = 0.0, -1.0  # union of device intervals, us
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + float(e["dur"]), c + 1)
    gnd = sum(t for k, (t, _) in by_name.items() if "gather_norm_dot" in k)
    n_launch = sum(c for _, c in by_name.values())
    print(f"trace (f32 bitmap, B=256, one batch): wall {wall * 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / 1e6 / wall:.4f}, {n_launch} device ops, "
          f"gather_norm_dot {gnd / 1e3:.3f} ms "
          f"({gnd / busy:.4f} of busy)")
    for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t / 1e3:9.3f} ms {c:6d}x  {k[:100]}")


def _time_ms(fn, n_ids: int) -> float:
    """Median per-launch ms of ``fn(i)`` over 5 rounds of 20 launches."""
    for i in range(3):
        fn(i % n_ids)
    rounds = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(20):
            fn(i % n_ids)
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end) / 20)
    return statistics.median(rounds)


def _quantize(f32: torch.Tensor, vec_dtype: str):
    """Device-side twin of ``repro_torch.core.store.quantize_rows``."""
    if vec_dtype == "f32":
        return f32, None
    if vec_dtype == "bf16":
        return f32.to(torch.bfloat16), None
    scales = f32.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    slab = torch.round(f32 / scales[:, None]).clamp(-127, 127)
    return slab.to(torch.int8), scales


def phase_kernels() -> dict:
    from repro_torch.kernels.gather_distance import gather_norm_dot
    from repro_torch.kernels.ref import gather_norm_dot_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's
    torch.backends.cudnn.allow_tf32 = False  # einsums stay full f32
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(32768, 8, 17, 128), (32768, 256, 17, 128),
              (2**21, 128, 48, 128)]
    cases = []
    max_err = 0.0
    for n, B, K, D in shapes:
        f32 = torch.randn(n, D, device="cuda", generator=gen)
        for vd in ("f32", "bf16", "int8"):
            table, scales = _quantize(f32, vd)
            ids = [torch.randint(0, n, (B, K), device="cuda", generator=gen)
                   for _ in range(20)]
            q = torch.randn(B, D, device="cuda", generator=gen)
            kd, kv = gather_norm_dot(table, ids[0], q, scales=scales)
            rd, rv = gather_norm_dot_ref(table, ids[0], q, scales=scales)
            torch.cuda.synchronize()
            vn = rv.double().sqrt()
            qn = q.double().norm(dim=1)[:, None]
            for got, exp, atol in ((kd, rd, vn * qn), (kv, rv, vn * vn)):
                err = (got.double() - exp.double()).abs()
                if bool((err > 1e-5 * exp.double().abs() + 1e-5 * atol).any()):
                    fail(f"gather_norm_dot {vd} n={n} B={B} K={K}: max err "
                         f"{float(err.max())}")
                max_err = max(max_err, float(err.max()))
            ms = _time_ms(lambda i: gather_norm_dot(table, ids[i], q,
                                                    scales=scales), 20)
            plain_ms = _time_ms(lambda i: gather_norm_dot_ref(
                table, ids[i], q, scales=scales), 20)
            rows = int(torch.unique(ids[0]).numel())
            nbytes = (rows * D * table.element_size()
                      + (rows * 4 if scales is not None else 0)
                      + B * K * 8 + B * D * 4 + 2 * B * K * 4)
            flops = 4 * B * K * D
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS * 1e3
            case = {"vec_dtype": vd, "n": n, "B": B, "K": K, "D": D,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes}
            cases.append(case)
            print(f"gather_norm_dot {vd:4s} n={n:7d} B={B:3d} K={K} D={D}: "
                  f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us), bound "
                  f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}, "
                  f"{nbytes} B)")
            del table, scales
        del f32
        torch.cuda.empty_cache()
    return {"cases": cases, "max_abs_err": max_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels.gather_distance import LAUNCHES

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    phase_build()
    served = phase_serve(LAUNCHES)
    phase_trace(served["out"])
    kern = phase_kernels()
    main_case = next(c for c in kern["cases"] if c["vec_dtype"] == "f32"
                     and c["B"] == 256 and c["K"] == 17)
    report = {"kernels": [{
        "name": "gather_norm_dot", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_norm_dot.cu",
        "replaces": "src/repro/kernels/gather_distance.py:123",
        "launches": served["launches"]["gather_norm_dot"],
        "max_abs_err": kern["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "shape": {k: main_case[k] for k in ("vec_dtype", "n", "B", "K", "D")},
    }]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
