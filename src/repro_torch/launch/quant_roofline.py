"""Arithmetic-intensity check of the quantised gather slabs (the port of
``repro.launch.quant_roofline``), and the serving kernel measured against
its byte bound on the card.

The claim of the quantised vector arenas: ``gather_norm_dot``'s flops do
not depend on the storage mode, while the bytes the gather moves scale
with the slab's dtype width, so arithmetic intensity (flops/byte) rises
~4x for int8 (per-row f32 scales) and ~2x for bf16 over the f32 slab.
The gather sits far left of the roofline ridge (memory-bound), so the
ratio is the speed-up ceiling of the fused-dequant kernel.

Method: ``launch.op_cost`` walks the plain ``gather_norm_dot``
(``kernels.ref.gather_norm_dot_ref``, the reference's ``backend="ref"``
formulation) per ``vec_dtype`` on ``meta`` tensors of a serving shape
(nothing allocated), its bytes counted as one fused program moves them
(``OpCost(fused=True)``: XLA fuses the reference's formulation, and the
CUDA kernel is one): the inputs once and the two [B, W] results, the
gathered rows and products staying on the chip.  The gather charges its
whole slab, as HLO operand bytes do, and that is the term that carries
the dtype width.  The flops
are the two contractions (the dot with the query and the squared norm),
each a product summed over a row: 2·B·W·d each, in every mode; the
dequantising multiply and the casts count none.  ``launch.roofline``
turns flops and bytes into the H100's terms.

``--measure`` (the card only; without CUDA it raises) times the CUDA
``gather_norm_dot`` per storage mode at the record's shape with CUDA
events (a CUDA graph of launches replayed: the device time) and prints
each time beside its byte bound (the distinct rows it reads, each byte
once, plus ids, queries, scales and the two outputs, over 3.35 TB/s),
with the card's name and power limit.

CLI::

  python -m repro_torch.launch.quant_roofline [--n N] [--d D] [--batch B]
                                              [--width W] [--gate]
                                              [--measure]

``--gate`` exits non-zero unless int8 AI >= 2.5x f32 and bf16 AI >=
1.5x f32.
"""
from __future__ import annotations

import torch

from . import op_cost
from .roofline import HBM_BW, roofline_terms

_SLAB_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}

#: --gate / test bars: minimum AI ratio vs the f32 slab.  The ideal
#: ratios are ~4x / ~2x; the bars sit below them because queries, ids,
#: scales, and the result tensor contribute mode-invariant bytes.
AI_GATE = {"int8": 2.5, "bf16": 1.5}


def gather_cost(vec_dtype: str, n: int = 1 << 17, d: int = 128,
                B: int = 128, W: int = 48) -> dict:
    """Walk the plain ``gather_norm_dot`` for one storage mode on ``meta``
    tensors (nothing allocated) -> its cost record."""
    from ..kernels.ref import gather_norm_dot_ref

    meta = dict(device="meta")
    table = torch.empty((n, d), dtype=_SLAB_DTYPES[vec_dtype], **meta)
    ids = torch.empty((B, W), dtype=torch.int32, **meta)
    qs = torch.empty((B, d), dtype=torch.float32, **meta)
    sc = (torch.empty((n,), dtype=torch.float32, **meta)
          if vec_dtype == "int8" else None)
    rec = op_cost.analyze(gather_norm_dot_ref, table, ids, qs, scales=sc,
                          fused=True)
    flops = rec["flops_per_device"]
    out = {
        "vec_dtype": vec_dtype,
        "shape": {"n": n, "d": d, "B": B, "W": W},
        "flops": flops,
        "bytes": rec["bytes_per_device"],
        "slab_bytes": n * d * table.element_size(),
        "ai": flops / max(rec["bytes_per_device"], 1.0),
    }
    out["terms"] = roofline_terms(flops, out["bytes"], 0.0, 1,
                                  per_device=True)
    return out


def verify(n: int = 1 << 17, d: int = 128, B: int = 128,
           W: int = 48) -> dict:
    """Cost records for all three storage modes + AI ratios vs f32."""
    recs = {m: gather_cost(m, n=n, d=d, B=B, W=W) for m in _SLAB_DTYPES}
    for m in ("int8", "bf16"):
        recs[m]["ai_vs_f32"] = recs[m]["ai"] / max(recs["f32"]["ai"], 1e-30)
    return recs


def kernel_bound_bytes(vec_dtype: str, d: int, B: int, W: int,
                       rows: float) -> float:
    """What the CUDA ``gather_norm_dot`` must move: each distinct
    gathered row once (its scale too for int8), the int64 ids and f32
    queries, the two [B, W] f32 outputs."""
    row = d * _SLAB_DTYPES[vec_dtype].itemsize + (
        4 if vec_dtype == "int8" else 0)
    return rows * row + B * W * 8 + B * d * 4 + 2 * B * W * 4


def measure(n: int = 1 << 17, d: int = 128, B: int = 128, W: int = 48,
            reps: int = 20, rounds: int = 5, seed: int = 0) -> dict:
    """Time the CUDA ``gather_norm_dot`` per storage mode against its byte
    bound, each result first held to the plain version (within 1e-5 of
    its value plus 1e-5 of |row| |query|, |row|^2 for the norm).  ``ms``:
    the device time of a launch, from ``reps`` launches (each its own
    random ids, as a wave's hops are) captured as one CUDA graph and
    replayed, the median of ``rounds`` CUDA-event windows, each after a
    write of 128 MiB that evicts L2; ``call_ms``: one eager call, host
    enqueue included.  The bound counts a launch's distinct rows (the
    mean over the ``reps`` id sets).  Raises without CUDA."""
    import statistics
    import subprocess

    from .. import resolve_device
    from ..kernels import gather_distance, ref

    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.randn((n, d), generator=gen, device=dev)
    ids = [torch.randint(0, n, (B, W), generator=gen, device=dev)
           for _ in range(reps)]  # int64, as the kernel takes them
    qs = torch.randn((B, d), generator=gen, device=dev)
    rows = sum(int(torch.unique(i).numel()) for i in ids) / reps
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    evict = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # 2.5x L2

    def timed(fn) -> float:
        times = []
        for _ in range(rounds):
            evict.zero_()  # every window starts from a cold L2
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        return statistics.median(times)

    out = {"card": smi, "shape": {"n": n, "d": d, "B": B, "W": W,
                                  "distinct_rows": rows}, "modes": {}}
    for mode, dt in _SLAB_DTYPES.items():
        scales = None
        if mode == "int8":
            scales = f32.abs().amax(dim=1).clamp(min=1e-12) / 127.0
            table = torch.round(f32 / scales[:, None]).clamp(
                -127, 127).to(torch.int8)
        else:
            table = f32.to(dt)
        launches0 = gather_distance.LAUNCHES["gather_norm_dot"]

        def kern(i: int = 0):
            return gather_distance.gather_norm_dot(table, ids[i], qs,
                                                   scales=scales)

        dots, norms = kern()
        edots, enorms = ref.gather_norm_dot_ref(table, ids[0], qs, scales)
        vn = enorms.double().sqrt()
        atol = {"dot": vn * qs.double().norm(dim=1)[:, None],
                "norm": vn * vn}
        err = 0.0
        for tag, got, exp in (("dot", dots, edots), ("norm", norms, enorms)):
            gap = (got.double() - exp.double()).abs()
            if bool((gap > 1e-5 * exp.double().abs() + 1e-5 * atol[tag])
                    .any()):
                raise AssertionError(f"gather_norm_dot {mode} {tag}: the "
                                     f"kernel differs from the plain "
                                     f"version by {float(gap.max())}")
            err = max(err, float(gap.max()))

        def loop():
            for i in range(reps):
                kern(i)

        call_ms = timed(loop) / reps
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            loop()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loop()
        ms = timed(graph.replay) / reps
        nbytes = kernel_bound_bytes(mode, d, B, W, rows)
        bound_ms = nbytes / HBM_BW * 1e3
        out["modes"][mode] = {
            "ms": ms, "call_ms": call_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "bound_share": bound_ms / ms,
            "max_abs_err": err,
            "launches": gather_distance.LAUNCHES["gather_norm_dot"]
            - launches0}
        del graph, table, scales
    return out


def main(argv: list[str] | None = None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(
        description="quantized-slab gather arithmetic-intensity check")
    ap.add_argument("--n", type=int, default=1 << 17, help="slab rows")
    ap.add_argument("--d", type=int, default=128, help="vector dim")
    ap.add_argument("--batch", type=int, default=128, help="queries per wave")
    ap.add_argument("--width", type=int, default=48, help="candidates/query")
    ap.add_argument("--gate", action="store_true",
                    help="non-zero exit unless the AI ratios clear AI_GATE")
    ap.add_argument("--measure", action="store_true",
                    help="time the CUDA kernel per mode (needs the card)")
    args = ap.parse_args(argv)
    recs = verify(n=args.n, d=args.d, B=args.batch, W=args.width)
    print(f"{'mode':>5} {'flops':>14} {'bytes':>14} {'AI':>9} "
          f"{'AI/f32':>7} {'memory_s':>10} bottleneck")
    for m, r in recs.items():
        print(f"{m:>5} {r['flops']:14.3e} {r['bytes']:14.3e} "
              f"{r['ai']:9.4f} {r.get('ai_vs_f32', 1.0):7.2f} "
              f"{r['terms']['memory_s']:10.3e} "
              f"{r['terms']['bottleneck']}")
    out = {"counted": recs}
    if args.gate:
        bad = [m for m, bar in AI_GATE.items()
               if recs[m]["ai_vs_f32"] < bar]
        if bad:
            raise SystemExit(
                f"quantized AI gate failed for {bad}: "
                f"{ {m: round(recs[m]['ai_vs_f32'], 2) for m in AI_GATE} } "
                f"vs bars {AI_GATE}")
        print("AI gate OK: "
              + ", ".join(f"{m} {recs[m]['ai_vs_f32']:.2f}x (bar {b}x)"
                          for m, b in AI_GATE.items()))
    if args.measure:
        meas = measure(n=args.n, d=args.d, B=args.batch, W=args.width)
        print(f"card: {meas['card']}")
        for m, r in meas["modes"].items():
            print(f"{m:>5} kernel {r['ms'] * 1e3:.3f} us device (a call "
                  f"{r['call_ms'] * 1e3:.2f} us), bound "
                  f"{r['bound_ms'] * 1e3:.3f} us ({r['bytes']} bytes over "
                  f"{HBM_BW / 1e12:.2f} TB/s), {r['bound_share']:.3f} of "
                  f"the bound's rate, max abs err {r['max_abs_err']:.2e}")
        out["measured"] = meas
    return out


if __name__ == "__main__":
    main()
