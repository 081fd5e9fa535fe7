#!/usr/bin/env python3
"""Time thread layouts of the ``wkv6`` CUDA kernel on the card.

    python3 tools/wkv6_sweep.py [--T 2048] [--B 8] [--reps 5] [--probes]

``src/repro_torch/csrc/wkv6.cu`` fixes its thread layout in two
constants: ``kGroups`` (threads that share a value column, each summing
its rows of y_t[j]) and ``kCols`` (value columns of a thread); and it
unrolls its step loop (``#pragma unroll 4``).  This script writes
variants of the source with other values into ``build/wkv6_sweep/``
(instantiated for N = 64 only), compiles them with ``nvcc`` in parallel
with the flags of ``repro_torch.kernels._build``, and times each at
rwkv6-1.6b's prefill shape (B 8, H 32, N 64, f32, a nonzero state),
after holding it against ``wkv6_chunked`` within the kernel's 3e-4.  It
prints one line a variant: registers, spills, ms (the median of
CUDA-event timings) and the ratio to the byte bound.  With ``--probes``
it times instead the source's own layout and probes that compute wrong
answers on purpose, to show what bounds the kernel: ``no_fp`` (the step
loop reads its operands but does 3 FP32 operations a row instead of 3 a
row and column), ``no_lds`` (the step loop takes r, k, w as constants
instead of reading them from shared memory), ``no_steps`` (no step
loop: the staging, b_t and y passes alone), ``no_ypass`` (no pass adding
the partial sums into y) and ``no_fetch`` (zeros staged instead of r, k,
w, v from device memory).  Run it again with ``--B 4`` to see whether the
time is per SM (it halves) or per block (it stays).  Needs one card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ref import wkv6_chunked  # noqa: E402

OUT = ROOT / "build" / "wkv6_sweep"
HBM_BYTES_PER_S = 3.35e12


def variant_source(groups: int, cols: int, unroll: int) -> str:
    src = (_build.CSRC / "wkv6.cu").read_text()
    for name, val in (("kGroups", groups), ("kCols", cols)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {val};", src)
        assert n == 1, name
    src, n = re.subn(
        r"#pragma unroll \d+\n(\s*for \(int t = 0; t < n; \+\+t\))",
        rf"#pragma unroll {unroll}\n\1", src)
    assert n == 1, "step loop"
    # N = 64 only: the other widths may not take this layout
    return src.replace("launch<T, 32>", "launch<T, 64>").replace(
        "launch<T, 128>", "launch<T, 64>")


STEP_FP = """            acc[q][e & 1] = fmaf(rr[e], s, acc[q][e & 1]);
            s = fmaf(ww[e], s, kk[e] * vv[q]);"""
PROBES = {
    "no_fp": [(STEP_FP, "            if (q == 0) "
                        "acc[0][e & 1] += rr[e] * kk[e] * ww[e];")],
    "no_lds": [(f"*reinterpret_cast<const float4*>(&{a}[b][t][row])",
                "make_float4(0.5f, 0.5f, 0.5f, 0.5f)")
               for a in ("sr", "sk", "sw")],
    "no_steps": [("for (int t = 0; t < n; ++t) {",
                  "for (int t = 0; t < 0; ++t) {")],
    "no_ypass": [("idx < n * (NMAX / 4); idx += kThreads", "idx < 0; ++idx")],
    # cp.async with a source size of 0: zero fill, no device-memory read
    "no_fetch": [(f'"r"(ok ? {n} : 0)', '"r"(0)') for n in (4, 16)],
}


def probe_source(name: str) -> str:
    src = variant_source(*SOURCE_LAYOUT)
    for old, new in PROBES[name]:
        assert old in src, (name, old)
        src = src.replace(old, new)
    return src


def layouts():
    """(groups, cols, unroll) that N = 64 takes: 4 rows a group at least,
    32 to 512 threads (b_t's reduction stays in a warp)."""
    for g, c, u in itertools.product((2, 4, 8, 16), (4, 8), (1, 2, 4)):
        threads = 64 // c * g
        if 64 // g >= 4 and 32 <= threads <= 512:
            yield g, c, u


def source_layout() -> tuple[int, int, int]:
    src = (_build.CSRC / "wkv6.cu").read_text()
    return (int(re.search(r"constexpr int kGroups = (\d+);", src).group(1)),
            int(re.search(r"constexpr int kCols = (\d+);", src).group(1)),
            int(re.search(r"#pragma unroll (\d+)\n\s*for \(int t = 0; t < n;",
                          src).group(1)))


SOURCE_LAYOUT = source_layout()


def build(tags: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src in tags.items():
        cu = OUT / f"{tag}.cu"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"{tag}.so"), str(cu)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    logs = {}
    for tag, p in procs.items():
        out, _ = p.communicate()
        logs[tag] = (p.returncode, out)
    return logs


def ptxas_f32(log: str) -> str:
    """registers and spills of the f32 instantiation"""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "wkv6_kernelIf" in line:
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
            regs = re.search(r"Used (\d+) registers", lines[i + 3])
            return (f"{regs.group(1) if regs else '?'} registers, "
                    f"{spill.group(1) if spill else '?'} B spilled")
    return "no report"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=2048)
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--probes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv6_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    if args.probes:
        g, c, u = SOURCE_LAYOUT
        variants = {f"g{g}_c{c}_u{u} (the source's)": variant_source(g, c, u),
                    **{name: probe_source(name) for name in PROBES}}
    else:
        variants = {f"g{g}_c{c}_u{u}": variant_source(g, c, u)
                    for g, c, u in layouts()}
    logs = build({tag.split()[0]: src for tag, src in variants.items()})

    B, H, T, N = args.B, 32, args.T, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn(B, H, T, N, device="cuda", generator=gen)
               for _ in range(3))
    w = 0.05 + 0.949 * torch.rand(B, H, T, N, device="cuda", generator=gen)
    u = torch.randn(H, N, device="cuda", generator=gen)
    s0 = torch.randn(B, H, N, N, device="cuda", generator=gen)
    ey, es = wkv6_chunked(r, k, v, w, u, state=s0, chunk=32)
    nbytes = 5 * B * H * T * N * 4 + 2 * B * H * N * N * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"B {B} H {H} T {T} N {N} f32: byte bound {bound:.4f} ms")
    for tag in variants:
        rc, log = logs[tag.split()[0]]
        if rc != 0:
            print(f"{tag}: does not build: {log.strip()[-600:]}")
            continue
        fn = getattr(ctypes.CDLL(str(OUT / f"{tag.split()[0]}.so")), "wkv6")
        fn.argtypes = list(_build.SIGNATURES["wkv6"])
        fn.restype = ctypes.c_int
        y = torch.empty_like(r)
        s = torch.empty_like(s0)

        def call():
            err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), s0.data_ptr(), y.data_ptr(), s.data_ptr(),
                     B, H, T, N, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{tag}: cudaError {err}")

        call()
        torch.cuda.synchronize()
        ok = all(bool(((a - b).abs() <= 3e-4 + 3e-4 * b.abs()).all())
                 for a, b in ((y, ey), (s, es)))
        for _ in range(3):
            call()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / args.reps)
        ms = statistics.median(times)
        print(f"{tag}: {ptxas_f32(log)}, {ms:.4f} ms, {ms / bound:.2f}x the "
              f"bound, {'agrees' if ok else 'DIFFERS from wkv6_chunked'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
