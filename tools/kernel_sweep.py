#!/usr/bin/env python3
"""Time variants of the ``mamba_scan``, ``batched_dot``, ``wkv6`` and
``gather_norm_dot`` CUDA kernels on the card.

    python3 tools/kernel_sweep.py mamba [--T 2048] [--probes] [--profile]
    python3 tools/kernel_sweep.py mamba --accuracy
    python3 tools/kernel_sweep.py batched_dot [--probes] [--also FILE.cu]
    python3 tools/kernel_sweep.py wkv6 [--T 2048] [--B 8] [--probes]
    python3 tools/kernel_sweep.py gather [--probes | --pdl] [--also FILE.cu]

Each kernel fixes its layout in a few constants.  This script writes
variants of the source with other values into ``build/kernel_sweep/``,
compiles them with ``nvcc`` in parallel with the flags of
``repro_torch.kernels._build``, checks each against the plain version and
times it with ``chip_smoke.py``'s timers.  One line a variant: its
constants, registers and spills and its time.  ``--probes`` times instead
the source beside probes that compute wrong answers on purpose, to show
what bounds the kernel.

``mamba``: ``kSteps`` (time steps per staged chunk), ``kStages`` (chunks
in the ring of staging buffers), ``kChanSmall`` (channels a thread at
N <= 16), ``kSmWarps`` (warps an SM must hold, which caps the registers)
and the unrolling of the step loop, at Jamba's prefill (B 8, T 2,048 or
``--T``, di 16,384, N 16, f32, A = -(1..N) spread per channel, dt =
softplus(randn - 1), a nonzero h0; the N = 16 template), held to
``mamba_scan_ref`` within 2e-5 + 2e-5 |ref|, timed by CUDA events (median
of 5 rounds of 5 launches) beside the byte bound and the SFU bound (every
exponential on the SFUs at 16 a clock per SM on 132 SMs at the SM clock
``nvidia-smi`` reads).  Probes: ``unguarded`` (the SFU alone, no
polynomial close to 1), ``no_exp`` (the argument in place of its
exponential), ``no_fetch`` (zeros staged instead of dt, x, Bm and Cm from
device memory), ``no_store`` (y not written) and ``no_steps`` (the
staging ring alone).  ``--profile`` prints the source's SASS opcode
counts (``cuobjdump -sass``; the whole kernel and its step loop) and the
SM clock and power ``nvidia-smi`` samples while it runs.  ``--accuracy``
prints, at the draw where decays stay closest to 1 (the CUDA test's: A =
-exp(N(0, 1)), dt log-uniform on [1e-3, 1e-1]), the largest error
against a scan in f64 of the plain version in f32 (card and CPU), the
source and ``unguarded``.

``batched_dot``: ``kWarps`` (warps a block) and ``kQuadMax`` (the widest
row that takes 8 lanes), at the smoke's five shapes, each held to
``batched_dot_ref`` within 1e-5 |v| |q| and timed device to device
beside ``torch.bmm`` on the same inputs (20 launches of each captured as
one CUDA graph, the two graphs replayed in turns, the median of 11
rounds).  Probes: ``q_aligned`` reads the query's floats as aligned
float4s of the wrong row; ``empty`` is the same grid returning at once
(the launch floor of a replayed graph).  ``--also FILE.cu`` times another
version of the source beside them, as it is (e.g. an older one: ``git
show REV:src/repro_torch/csrc/batched_dot.cu > build/x.cu``).

``wkv6``: ``kGroups`` (threads that share a value column, each summing
its rows of y_t[j]), ``kCols`` (value columns of a thread) and the
unrolling of the step loop, for N = 64 at rwkv6-1.6b's prefill (B 8 or
``--B``, H 32, N 64, f32, a nonzero state), held to ``wkv6_chunked``
within 3e-4.  Probes: ``no_fp`` (3 FP32 operations a row instead of 3 a
row and column), ``no_lds`` (r, k, w as constants instead of from shared
memory), ``no_steps`` (the staging, b_t and y passes alone),
``no_ypass`` (no pass adding the partial sums into y) and ``no_fetch``
(zeros staged instead of r, k, w, v from device memory).  ``--B 4``
shows whether the time is per SM (it halves) or per block (it stays).

``gather``: ``kWarps`` (warps a block), ``kMax8`` and ``kMax16`` (the
widest rows, in values, that take 8 and 16 lanes), ``kSlots`` (words a
lane loads before its first FMA) and ``warp_store`` (lane r stores row
r0 + r, its sums shuffled from the row's group, instead of each group's
first lane storing its row), at ``chip_smoke.py``'s nine cases (n
32,768, B 8 and 256, K 17; n 2^21, B 128, K 48; D 128; f32, bf16, int8),
each held to ``gather_norm_dot_ref`` within 1e-5 |v| |q| and timed device
to device: 20 launches on 20 id sets captured as one CUDA graph, every
variant's graph replayed in turns with the others, the median of 11
rounds (for the 2^21-row table after evicting L2, the ids and queries
read back: ``chip_smoke._cold_l2``), the source twice (``source`` and
``source'``: their gap is the in-turns spread).  Probes: ``empty`` (the
same grid returning at once: the launch floor of a replayed graph), ``no_fetch`` (every row read from id 0: no
id load and no dependent gather) and ``no_reduce`` (no butterfly).
``--pdl`` times the source against a programmatic dependent launch of it
(``cudaLaunchKernelEx`` with programmatic stream serialization,
``griddepcontrol.wait`` before the first read), each launch behind a
torch op that writes its ids (a clamp), as a hop does, and the clamp
alone.  ``--also FILE.cu`` as for ``batched_dot``.

Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_S, _cold_l2, _graph_ms_alternating, _quantize, _time_ms)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    batched_dot_ref, gather_norm_dot_ref, mamba_scan_ref, wkv6_chunked)

OUT = ROOT / "build" / "kernel_sweep"
SMS, SFU_PER_CLOCK = 132, 16


def constants(name: str, keys) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in keys}


def variant_source(name: str, values: dict, replace=()) -> str:
    """``name``'s source with the constants ``values`` and each (regular
    expression, replacement) of ``replace`` applied."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for key, val in values.items():
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {val};", src)
        assert n == 1, key
    for pattern, new in replace:
        src, n = re.subn(pattern, new, src)
        assert n >= 1, pattern
    return src


def tag_of(values: dict) -> str:
    return "_".join(f"{k[1:]}-{v}" for k, v in values.items())


def build(sources: dict) -> dict:
    """Compile every source in parallel -> {tag: (returncode, log)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src in sources.items():
        cu = OUT / f"{tag}.cu"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"{tag}.so"), str(cu)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    logs = {tag: p.communicate()[0] for tag, p in procs.items()}
    return {tag: (procs[tag].returncode, log) for tag, log in logs.items()}


def ptxas(log: str, kernel: str) -> str:
    """registers and spills of the entry whose mangled name has
    ``kernel``"""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
            regs = re.search(r"Used (\d+) registers", lines[i + 3])
            return (f"{regs.group(1) if regs else '?'} registers, "
                    f"{spill.group(1) if spill else '?'} B spilled")
    return "no report"


def built(logs: dict):
    """(tag, log, the bound C entry's loader) of each variant that built;
    prints the others."""
    for tag, (rc, log) in logs.items():
        if rc != 0:
            print(f"{tag}: does not build: {log.strip()[-600:]}")
            continue
        yield tag, log, ctypes.CDLL(str(OUT / f"{tag}.so"))


def bind(lib, name: str):
    fn = getattr(lib, name)
    fn.argtypes = list(_build.SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def checked(tag: str, fn, *args):
    """A no-argument launch of ``fn(*args, stream)`` that raises on a
    refused launch."""
    def call(_=None):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{tag}: cudaError {err}")
    return call


def event_ms(call, reps: int = 5) -> float:
    return _time_ms(call, 1, reps=reps, rounds=5)


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


MAMBA_KEYS = ("kThreads", "kSteps", "kStages", "kChanSmall", "kSmWarps")
MAMBA_ONLY16 = [(f"launch<{n}>", "launch<16>") for n in (4, 8, 32, 64)]
STEP_UNROLL = (r"#pragma unroll \d+(\n\s*for \(int s = 0; s < len; "
               r"\+\+s, at \+= di\))")
MAMBA_PROBES = {  # (regular expression, replacement)
    "unguarded": [(re.escape("return x > -kNear ? p : m;"), "return m;")],
    "no_exp": [(re.escape("const float e = ex2_guarded(dtv[c] * a[c][n]);"),
                "const float e = dtv[c] * a[c][n];")],
    # cp.async with a source size of 0: zero fill, no device-memory read
    "no_fetch": [(re.escape('"r"(ok ? 16 : 0)'), '"r"(0)'),
                 (re.escape('"r"(ok ? 4 : 0)'), '"r"(0)')],
    "no_store": [(re.escape("y[at + c * kThreads] ="),
                  "if (dtv[c] == 12345.f) y[at + c * kThreads] =")],
    # the staging ring alone: no step is computed
    "no_steps": [(re.escape("scan_chunk<NMAX>(h, a,"),
                  "if (false) scan_chunk<NMAX>(h, a,")],
}


def mamba_variants(probes: bool) -> dict:
    """tag -> source, N = 16 only (every dispatch goes to launch<16>)."""
    src = constants("mamba_scan", MAMBA_KEYS)
    if probes:
        out = {f"{tag_of(src)}_source":
               variant_source("mamba_scan", {}, MAMBA_ONLY16)}
        for name, rep in MAMBA_PROBES.items():
            out[name] = variant_source("mamba_scan", {}, MAMBA_ONLY16 + rep)
        return out
    grid = [(dict(src), 1)]
    grid += [(dict(src, kSteps=t, kStages=r), 1)
             for t, r in ((8, 2), (8, 4), (4, 3), (16, 2))]
    grid += [(dict(src, kChanSmall=c, kSmWarps=w), 1)
             for c, w in ((1, 16), (1, 24), (4, 8), (2, 8), (2, 12), (2, 20))]
    grid += [(dict(src), 2)]
    out = {}
    for values, unroll in grid:
        rep = MAMBA_ONLY16 + [(STEP_UNROLL, rf"#pragma unroll {unroll}\1")]
        out.setdefault(f"{tag_of(values)}_Unroll-{unroll}",
                       variant_source("mamba_scan", values, rep))
    return out


def _opcodes(lines) -> str:
    counts: dict[str, int] = {}
    for line in lines:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])
    return (f"{sum(counts.values())} instructions: "
            + ", ".join(f"{op} {n}" for op, n in top[:12]))


def sass_histogram(so: Path, kernel: str) -> str:
    """Opcode counts of the SASS of the entry whose name has ``kernel``
    (``cuobjdump -sass``), most frequent first, and of its longest
    innermost loop (a branch back to a lower address closes a loop: for
    ``mamba_scan``, the step loop)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    body = sass[sass.index(kernel):]
    body = body[:body.find("Function :", 10)] if "Function :" in body[10:] \
        else body
    lines = [ln for ln in body.splitlines()
             if re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln)]
    pcs = [int(re.search(r"/\*([0-9a-f]{4,})\*/", ln).group(1), 16)
           for ln in lines]
    spans = []  # (first, last) line of each loop
    for i, ln in enumerate(lines):
        m = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", ln)
        if m and int(m.group(1), 16) < pcs[i]:
            spans.append((pcs.index(int(m.group(1), 16)), i))
    inner = [(a, b) for a, b in spans  # no other loop closes inside
             if not any(a <= c < b for _, c in spans)]
    loops = sorted((lines[a:b + 1] for a, b in inner), key=len, reverse=True)
    return "\n".join([f"whole kernel: {_opcodes(lines)}"]
                     + [f"loop {j + 1}: {_opcodes(loop)}"
                        for j, loop in enumerate(loops[:1])])


def clocks_under_load(call, seconds: float = 2.0) -> str:
    """SM clock and power draw sampled by ``nvidia-smi`` while ``call``
    runs back to back for about ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    start = time.time()
    while time.time() - start < seconds:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.strip()]
    mhz = sorted(float(r[0]) for r in rows)
    watts = sorted(float(r[1]) for r in rows)
    return (f"under load: SM clock median {mhz[len(mhz) // 2]:.0f} MHz "
            f"(min {mhz[0]:.0f}), power median {watts[len(watts) // 2]:.0f} "
            f"W, {len(rows)} samples")


def sweep_mamba(T: int, probes: bool, profile: bool = False) -> None:
    variants = mamba_variants(probes)
    if profile:  # the source's constants only
        variants = dict(list(variants.items())[:1])
    logs = build(variants)
    B, di, N = 8, 16384, 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    A = -(torch.arange(1, N + 1, device="cuda").float()
          * torch.exp(0.1 * torch.randn(di, N, device="cuda", generator=gen)))
    dt = F.softplus(torch.randn(B, T, di, device="cuda", generator=gen) - 1)
    Bm, Cm = (torch.randn(B, T, N, device="cuda", generator=gen)
              for _ in range(2))
    x = torch.randn(B, T, di, device="cuda", generator=gen)
    h0 = torch.randn(B, di, N, device="cuda", generator=gen)
    ey, eh = mamba_scan_ref(A, dt, Bm, Cm, x, h0)
    nbytes = (3 * B * T * di + 2 * B * T * N + di * N + 2 * B * di * N) * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    y, hT = torch.empty_like(x), torch.empty_like(h0)
    ptrs = [t.data_ptr() for t in (A, dt, Bm, Cm, x, h0, y, hT)]
    print(f"B {B} T {T} di {di} N {N} f32: byte bound {byte_ms:.4f} ms")
    for tag, log, lib in built(logs):
        call = checked(tag, bind(lib, "mamba_scan"), *ptrs, B, T, di, N)
        call()
        torch.cuda.synchronize()
        ok = all(bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all())
                 for a, b in ((y, ey), (hT, eh)))
        ms = event_ms(call)
        mhz = sm_clock_mhz()  # read right after the timed launches
        sfu_ms = B * T * di * N / (SFU_PER_CLOCK * SMS * mhz * 1e6) * 1e3
        if profile:
            print(sass_histogram(OUT / f"{tag}.so", "mamba_scan_kernelILi16E"))
            print(clocks_under_load(call))
        print(f"{tag}: {ptxas(log, 'mamba_scan_kernelILi16E')}, {ms:.4f} ms, "
              f"{ms / byte_ms:.2f}x the byte bound; SFU bound {sfu_ms:.4f} "
              f"ms (SM clock {mhz:.0f} MHz); "
              f"{'agrees' if ok else 'DIFFERS from mamba_scan_ref'}")


def accuracy_mamba() -> None:
    """At the draw where decays stay closest to 1 (the CUDA test's: B 2, T
    2,048, di 256, N 16, A = -exp(N(0, 1)), dt log-uniform on [1e-3,
    1e-1]), each version's largest error against a scan in f64, as a share
    of the rule 2e-5 + 2e-5 |ref|: the plain version in f32 on the card
    and on the CPU, the source, and the source unguarded."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_mamba import _scan_inputs, _t
    from test_torch_mamba_exp_rounding import scan_f64

    A, _, Bm, Cm, x, h0 = _scan_inputs(2, 2048, 256, 16, seed=5)
    rng = np.random.default_rng(6)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), x.shape)) \
        .astype(np.float32)
    args = _t(A, dt, Bm, Cm, x, h0)
    ry, rh = scan_f64(*args)

    def share(y, h) -> str:
        y, h = y.cpu().double(), h.cpu().double()
        worst = max(float(((g - r).abs() / (2e-5 + 2e-5 * r.abs())).max())
                    for g, r in ((y, ry), (h, rh)))
        return f"{worst:.3f} of the rule ({float((y - ry).abs().max()):.3e})"

    cuda = tuple(a.cuda() for a in args)
    print(f"plain, f32 on the card: {share(*mamba_scan_ref(*cuda))}")
    print(f"plain, f32 on the CPU: {share(*mamba_scan_ref(*args))}")
    variants = {"source": variant_source("mamba_scan", {}, MAMBA_ONLY16),
                "unguarded": variant_source(
                    "mamba_scan", {},
                    MAMBA_ONLY16 + MAMBA_PROBES["unguarded"])}
    for tag, _, lib in built(build(variants)):
        y, h = torch.empty_like(cuda[4]), torch.empty_like(cuda[5])
        checked(tag, bind(lib, "mamba_scan"),
                *(t.data_ptr() for t in cuda), y.data_ptr(), h.data_ptr(),
                2, 2048, 256, 16)()
        torch.cuda.synchronize()
        print(f"{tag}: {share(y, h)}")


DOT_SHAPES = ((8, 17, 128), (256, 17, 128), (128, 48, 128), (256, 17, 24),
              (256, 17, 33))
DOT_PROBES = {  # (regular expression, replacement)
    # the query's floats read as aligned float4s (of the row itself)
    "q_aligned": [(re.escape("const int m = misalign(qb + head);"),
                   "const int m = 0;"),
                  (re.escape("reinterpret_cast<const float4*>(qb + head - m);"),
                   "reinterpret_cast<const float4*>(vb + head);")],
    # the same grid, returning at once
    "empty": [(re.escape("  const int lane = threadIdx.x & 31;\n"),
               r"  if (rows > 0) return;\n\g<0>")],
}


def sweep_batched_dot(also: list, probes: bool) -> None:
    src = constants("batched_dot", ("kWarps", "kQuadMax", "kPairMax"))
    if probes:
        variants = {"source": variant_source("batched_dot", {})}
        variants.update({name: variant_source("batched_dot", {}, rep)
                         for name, rep in DOT_PROBES.items()})
    else:
        grid = [dict(src, kWarps=w, kQuadMax=m)
                for w, m in itertools.product((4, 8), (32, 48, 64))]
        variants = {tag_of(g) + ("_source" if g == src else ""):
                    variant_source("batched_dot", g) for g in grid}
    for path in also:  # another version of the source, as it is
        variants[Path(path).stem] = Path(path).read_text()
    logs = build(variants)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for B, K, D in DOT_SHAPES:
        v = torch.randn(B, K, D, device="cuda", generator=gen)
        q = torch.randn(B, D, device="cuda", generator=gen)
        out = torch.empty(B, K, device="cuda")
        atol = v.double().norm(dim=2) * q.double().norm(dim=1)[:, None]
        bmm = (lambda _, v=v, q=q: torch.bmm(v, q[:, :, None]))
        data[(B, K, D)] = (v, q, out, batched_dot_ref(v, q), atol, bmm)
    for tag, log, lib in built(logs):
        fn = bind(lib, "batched_dot")
        cells = []
        for (B, K, D), (v, q, out, exp, atol, bmm) in data.items():
            call = checked(tag, fn, v.data_ptr(), q.data_ptr(),
                           out.data_ptr(), B, K, D)
            call()
            torch.cuda.synchronize()
            err = (out.double() - exp.double()).abs()
            ok = bool((err <= 1e-5 * exp.double().abs() + 1e-5 * atol).all())
            us, bmm_us = (t * 1e3
                          for t in _graph_ms_alternating((call, bmm), 1))
            cells.append(f"D{D} B{B} K{K} {us:.3f} us against {bmm_us:.3f} "
                         f"({us / bmm_us:.2f}x"
                         f"{'' if ok else ', DIFFERS'})")
        print(f"{tag}: {ptxas(log, 'batched_dot_kernel')}; "
              + ", ".join(cells))


# N = 64 only: the other widths may not take every layout
WKV6_ONLY64 = [(re.escape("launch<T, 32>"), "launch<T, 64>"),
               (re.escape("launch<T, 128>"), "launch<T, 64>")]
WKV6_UNROLL = r"#pragma unroll \d+(\n\s*for \(int t = 0; t < n; \+\+t\))"
WKV6_STEP_FP = """            acc[q][e & 1] = fmaf(rr[e], s, acc[q][e & 1]);
            s = fmaf(ww[e], s, kk[e] * vv[q]);"""
WKV6_PROBES = {  # (regular expression, replacement)
    "no_fp": [(re.escape(WKV6_STEP_FP),
               "            if (q == 0) "
               "acc[0][e & 1] += rr[e] * kk[e] * ww[e];")],
    "no_lds": [(re.escape(f"*reinterpret_cast<const float4*>(&{a}[b][t][row])"),
                "make_float4(0.5f, 0.5f, 0.5f, 0.5f)")
               for a in ("sr", "sk", "sw")],
    "no_steps": [(re.escape("for (int t = 0; t < n; ++t) {"),
                  "for (int t = 0; t < 0; ++t) {")],
    "no_ypass": [(re.escape("idx < n * (NMAX / 4); idx += kThreads"),
                  "idx < 0; ++idx")],
    # cp.async with a source size of 0: zero fill, no device-memory read
    "no_fetch": [(re.escape(f'"r"(ok ? {n} : 0)'), '"r"(0)')
                 for n in (4, 16)],
}


def wkv6_variants(probes: bool) -> dict:
    src = (_build.CSRC / "wkv6.cu").read_text()
    layout = dict(constants("wkv6", ("kGroups", "kCols")), kUnroll=int(
        re.search(WKV6_UNROLL.replace(r"\d+", r"(\d+)", 1), src).group(1)))

    def source(groups, cols, unroll, extra=()):
        return variant_source(
            "wkv6", {"kGroups": groups, "kCols": cols},
            WKV6_ONLY64 + [(WKV6_UNROLL, rf"#pragma unroll {unroll}\1")]
            + list(extra))

    if probes:
        out = {f"{tag_of(layout)}_source": source(*layout.values())}
        out.update({name: source(*layout.values(), rep)
                    for name, rep in WKV6_PROBES.items()})
        return out
    # 4 rows a group at least, 32 to 512 threads (b_t's reduction stays in
    # a warp)
    return {tag_of({"kGroups": g, "kCols": c, "kUnroll": u}): source(g, c, u)
            for g, c, u in itertools.product((2, 4, 8, 16), (4, 8), (1, 2, 4))
            if 64 // g >= 4 and 32 <= 64 // c * g <= 512}


def sweep_wkv6(T: int, B: int, probes: bool) -> None:
    logs = build(wkv6_variants(probes))
    H, N = 32, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn(B, H, T, N, device="cuda", generator=gen)
               for _ in range(3))
    w = 0.05 + 0.949 * torch.rand(B, H, T, N, device="cuda", generator=gen)
    u = torch.randn(H, N, device="cuda", generator=gen)
    s0 = torch.randn(B, H, N, N, device="cuda", generator=gen)
    ey, es = wkv6_chunked(r, k, v, w, u, state=s0, chunk=32)
    nbytes = 5 * B * H * T * N * 4 + 2 * B * H * N * N * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    y, s = torch.empty_like(r), torch.empty_like(s0)
    print(f"B {B} H {H} T {T} N {N} f32: byte bound {bound:.4f} ms")
    for tag, log, lib in built(logs):
        call = checked(tag, bind(lib, "wkv6"),
                       *(t.data_ptr() for t in (r, k, v, w, u, s0, y, s)),
                       B, H, T, N, 0)
        call()
        torch.cuda.synchronize()
        ok = all(bool(((a - b).abs() <= 3e-4 + 3e-4 * b.abs()).all())
                 for a, b in ((y, ey), (s, es)))
        ms = event_ms(call)
        print(f"{tag}: {ptxas(log, 'wkv6_kernelIf')}, {ms:.4f} ms, "
              f"{ms / bound:.2f}x the bound, "
              f"{'agrees' if ok else 'DIFFERS from wkv6_chunked'}")


GATHER_KEYS = ("kWarps", "kMax8", "kMax16", "kSlots")
GATHER_CASES = [(n, B, K, 128, vd)
                for n, B, K in ((32768, 8, 17), (32768, 256, 17),
                                (2**21, 128, 48))
                for vd in ("f32", "bf16", "int8")]
GATHER_ENTRY = re.escape(
    "  const int lane = threadIdx.x & 31, g = lane / G, lg = lane % G;\n")
GATHER_PROBES = {  # (regular expression, replacement)
    "empty": [(GATHER_ENTRY, r"  if (rows > 0) return;\n\g<0>")],
    "no_fetch": [(re.escape("id = __ldg(ids + r0 + g);"), "id = 0;")],
    "no_reduce": [(re.escape("int off = G / 2; off > 0;"),
                   "int off = G / 2; off > G;")],
}
GATHER_WARP_STORE = [(re.escape("""  if (lg == 0 && live) {
    dots[r0 + g] = d * s;
    v2[r0 + g] = e * (s * s);"""),
                      """  d = __shfl_sync(kFull, d * s, lane * G);
  e = __shfl_sync(kFull, e * (s * s), lane * G);
  if (lane < R && r0 + lane < rows) {
    dots[r0 + lane] = d;
    v2[r0 + lane] = e;""")]
GATHER_PDL = [
    (GATHER_ENTRY,
     r'  asm volatile("griddepcontrol.wait;" ::: "memory");\n\g<0>'),
    (re.escape("kern<<<static_cast<unsigned>(grid), kWarps * 32, 0, "
               "stream>>>("),
     """cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kern, """)]


def gather_variants(probes: bool, pdl: bool) -> dict:
    src = constants("gather_norm_dot", GATHER_KEYS)
    if pdl:
        return {"source": variant_source("gather_norm_dot", {}),
                "pdl": variant_source("gather_norm_dot", {}, GATHER_PDL)}
    if probes:
        out = {"source": variant_source("gather_norm_dot", {})}
        out.update({name: variant_source("gather_norm_dot", {}, rep)
                    for name, rep in GATHER_PROBES.items()})
        return out
    grid = [dict(src, kWarps=w) for w in (4, 8, 16)]
    # D = 128 takes 8, 16 or 32 lanes
    grid += [dict(src, kMax8=a, kMax16=b) for a, b in ((128, 256), (48, 64))]
    grid += [dict(src, kSlots=k) for k in (1, 4)]
    out = {}
    for g in grid:
        out.setdefault(tag_of(g) + ("_source" if g == src else ""),
                       variant_source("gather_norm_dot", g))
    out["warp_store"] = variant_source("gather_norm_dot", {},
                                       GATHER_WARP_STORE)
    return out


def gather_ptxas(log: str, source: str) -> str:
    """registers and spills of the aligned instantiation each type takes
    at D = 128 (``source`` gives the thresholds), or of a source without
    them"""
    found = {k: int(m.group(1)) for k in ("kMax8", "kMax16")
             if (m := re.search(rf"constexpr int {k} = (\d+);", source))}
    out = []
    for name, mangled in (("f32", "f"), ("bf16", "13__nv_bfloat16"),
                          ("int8", "a")):
        if len(found) == 2:
            G = (8 if 128 <= found["kMax8"] else 16 if 128 <= found["kMax16"]
                 else 32)
            pattern = f"gather_norm_dot_kernelI{mangled}Li{G}ELb1E"
        else:
            pattern = f"gather_norm_dot_kernelI{mangled}E"
        out.append(f"{name} {ptxas(log, pattern)}")
    return "; ".join(out)


def sweep_gather(also: list, probes: bool, pdl: bool) -> None:
    variants = gather_variants(probes, pdl)
    for path in also:  # another version of the source, as it is
        variants[Path(path).stem] = Path(path).read_text()
    logs = build(variants)
    libs = []
    for tag, log, lib in built(logs):
        print(f"{tag}: {gather_ptxas(log, variants[tag])}")
        libs.append((tag, bind(lib, "gather_norm_dot")))
    # the source twice: their gap is the in-turns spread
    at = next(i for i, (tag, _) in enumerate(libs) if "source" in tag)
    libs.insert(at + 1, (libs[at][0] + "'", libs[at][1]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    codes = {"f32": 0, "bf16": 1, "int8": 2}
    results = {tag: [] for tag, _ in libs}
    heads = []
    for n, B, K, D, vd in GATHER_CASES:
        table, scales = _quantize(torch.randn(n, D, device="cuda",
                                              generator=gen), vd)
        ids = [torch.randint(0, n, (B, K), device="cuda", generator=gen)
               for _ in range(20)]
        idb = [torch.empty_like(i) for i in ids]  # the clamp's output
        q = torch.randn(B, D, device="cuda", generator=gen)
        rd, rv = gather_norm_dot_ref(table, ids[0], q, scales=scales)
        vn = rv.double().sqrt()
        atol = vn * q.double().norm(dim=1)[:, None]
        calls = []
        for tag, fn in libs:
            dots, v2 = (torch.empty(B, K, device="cuda") for _ in range(2))

            def call(i, fn=fn, dots=dots, v2=v2, tag=tag):
                src = ids[i]
                if pdl:  # a torch op writes the ids, as in a hop
                    src = torch.clamp(ids[i], 0, n - 1, out=idb[i])
                checked(tag, fn, table.data_ptr(), codes[vd],
                        None if scales is None else scales.data_ptr(),
                        src.data_ptr(), q.data_ptr(), dots.data_ptr(),
                        v2.data_ptr(), B, K, D, n)()
            call(0)
            torch.cuda.synchronize()
            ok = all(bool(((got.double() - exp.double()).abs()
                           <= 1e-5 * exp.double().abs() + 1e-5 * tol).all())
                     for got, exp, tol in ((dots, rd, atol),
                                           (v2, rv, vn * vn)))
            calls.append((tag, call, ok))
        fns = [c for _, c, _ in calls]
        if pdl:  # the clamp alone
            fns.append(lambda i: torch.clamp(ids[i], 0, n - 1, out=idb[i]))
        # the 2^21-row table: rows gathered from a cold L2, as a caller
        # finds them (its 20 id sets would otherwise stay in L2 from one
        # replay to the next for bf16 and int8)
        cold = _cold_l2([*ids, q]) if n > 2**20 else None
        times = _graph_ms_alternating(fns, 20, before=cold)
        for (tag, _, ok), t in zip(calls, times):
            results[tag].append(f"{t * 1e3:.3f}{'' if ok else ' DIFFERS'}")
        if pdl:
            results.setdefault("clamp alone", []).append(
                f"{times[-1] * 1e3:.3f}")
        rows = int(torch.unique(ids[0]).numel())
        nbytes = (rows * D * table.element_size()
                  + (rows * 4 if scales is not None else 0)
                  + B * K * 8 + B * D * 4 + 2 * B * K * 4)
        heads.append(f"{vd} n{n} B{B} K{K} (bound "
                     f"{nbytes / HBM_BYTES_PER_S * 1e6:.3f}"
                     f"{', cold L2' if cold else ''})")
        del table, scales
        torch.cuda.empty_cache()
    print("us a launch, device to device; " + " | ".join(heads))
    for tag, cells in results.items():
        print(f"{tag}: " + " | ".join(cells))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel",
                    choices=("mamba", "batched_dot", "wkv6", "gather"))
    ap.add_argument("--T", type=int, default=2048)
    ap.add_argument("--B", type=int, default=8, help="wkv6: the batch")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--also", action="append", default=[],
                    help="batched_dot, gather: time this .cu file too, as "
                         "it is")
    ap.add_argument("--pdl", action="store_true",
                    help="gather: the source against a programmatic "
                         "dependent launch of it, behind a torch op")
    ap.add_argument("--accuracy", action="store_true",
                    help="mamba: errors against an f64 scan where decays "
                         "stay close to 1")
    ap.add_argument("--profile", action="store_true",
                    help="mamba: the source's SASS opcode counts and the SM "
                         "clock and power while it runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    if args.kernel == "mamba":
        if args.accuracy:
            accuracy_mamba()
        else:
            sweep_mamba(args.T, args.probes, args.profile)
    elif args.kernel == "batched_dot":
        sweep_batched_dot(args.also, args.probes)
    elif args.kernel == "gather":
        sweep_gather(args.also, args.probes, args.pdl)
    else:
        sweep_wkv6(args.T, args.B, args.probes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
