"""Serving launcher: build a WoW index (on the host, or on the device with
``--build-backend device``), upload its snapshot to the device once, and
serve batched range-filtered queries through the device hop loop
(``repro_torch.core.device_search``).

    PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --queries 256
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 1200 --dim 16
    PYTHONPATH=src python -m repro_torch.launch.serve --build-backend device \\
        --pipeline fused reference --ingest 400

``--vec-dtype``, ``--pipeline``, ``--visited``, ``--compact`` and
``--backend`` each take one or more values; every combination is served
over the one build (the build dominates the run time), each as one warm-up
batch and one timed batch.  ``--ingest N`` then streams N more vectors
through ``insert_batch`` on the build backend, refreshes the snapshot
incrementally (``take_snapshot(prev=...)``) and re-serves every
combination once.  ``main(argv)`` also returns what it printed — the
build's rate and kernel launches, per configuration the recall, mean DC,
hop percentiles, QPS, the kernel launches of the timed batch and the raw
results — with the snapshots and workload it served.
"""
from __future__ import annotations

import argparse
import itertools
import time


def _parse_compact(spec: str):
    if spec in ("", "none"):
        return None
    h0, h1 = (int(x) for x in spec.split(","))
    return (h0, h1)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description="repro_torch WoW serving launcher")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--ef-construction", type=int, default=64)
    ap.add_argument("--o", type=int, default=4)
    ap.add_argument("--backend", nargs="+", default=["auto"],
                    choices=("auto", "cuda", "ref"),
                    help="distance-kernel dispatch (see "
                         "repro_torch.kernels.ops): auto = CUDA kernel on "
                         "the card, plain torch on the CPU")
    ap.add_argument("--vec-dtype", nargs="+", default=["f32"],
                    choices=("f32", "int8", "bf16"),
                    help="on-device vector-slab storage: f32, int8 "
                         "(per-row f32 scales) or bf16; dequant happens "
                         "inside the gather kernel (quantized modes require "
                         "--pipeline fused).  One value also sets the build "
                         "arena's storage (ops and device backends); "
                         "several build at f32")
    ap.add_argument("--pipeline", nargs="+", default=["fused"],
                    choices=("fused", "reference"),
                    help="hop pipeline: fused (production) or the "
                         "pre-refactor reference (materialized gather + the "
                         "batched_dot kernel; the parity oracle)")
    ap.add_argument("--visited", nargs="+", default=["bitmap"],
                    choices=("bitmap", "hash"),
                    help="visited-set state: exact [B, n/32] bitmap or the "
                         "constant-size blocked Bloom filter")
    ap.add_argument("--visited-bits", type=int, default=None,
                    help="hash-filter bits per query (pow2; default sized "
                         "from the search budget at a 2%% FP target)")
    ap.add_argument("--compact", nargs="+", default=["none"],
                    help='ragged-batch compaction schedule "H0,H" (e.g. '
                         '"8,8"), or "none" for the lock-step loop')
    ap.add_argument("--build-batch", type=int, default=128,
                    help="micro-batch size for batched construction "
                         "(insert_batch); 0 = the sequential insert loop")
    ap.add_argument("--build-backend", default="numpy",
                    choices=("numpy", "ops", "device"),
                    help="insert_batch phase-1 engine: host BLAS (numpy), "
                         "host search + fused gather kernel (ops), or the "
                         "device-resident build — the hop pipeline over the "
                         "frozen snapshot + delta arena (device)")
    ap.add_argument("--ingest", type=int, default=0,
                    help="ingest-while-serve: after the first serve wave, "
                         "stream N extra vectors through insert_batch, "
                         "refresh the snapshot incrementally and re-serve "
                         "the queries")
    ap.add_argument("--device", default=None,
                    help="torch device to build and serve on (default: "
                         "cuda)")
    args = ap.parse_args(argv)
    if "reference" in args.pipeline and set(args.vec_dtype) != {"f32"}:
        ap.error("--vec-dtype int8/bf16 requires --pipeline fused (the "
                 "reference pipeline has no fused-dequant gather)")
    compacts = [_parse_compact(c) for c in args.compact]

    import numpy as np
    import torch

    from .. import resolve_device
    from ..core import WoWIndex, make_workload, recall
    from ..core.datasets import make_attrs, make_vectors
    from ..core.device_search import (
        device_search, pad_queries, to_device_index,
    )
    from ..core.snapshot import take_snapshot
    from ..kernels import launch_counters

    dev = resolve_device(args.device)
    counters = launch_counters()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def launches() -> dict:
        return {k: v for c in counters for k, v in c.items()}

    def since(before: dict) -> dict:
        return {k: v - before[k] for k, v in launches().items()}

    wl = make_workload(n=args.n, d=args.dim, nq=args.queries, seed=0,
                       k=args.k)
    # one --vec-dtype builds at that storage mode, as the JAX launcher does
    build_dtype = args.vec_dtype[0] if len(args.vec_dtype) == 1 else "f32"
    idx = WoWIndex(dim=args.dim, m=args.m,
                   ef_construction=args.ef_construction, o=args.o, seed=0,
                   vec_dtype=build_dtype, device=dev)
    before = launches()
    t0 = time.time()
    if args.build_batch > 0:
        idx.insert_batch(wl.vectors, wl.attrs, batch_size=args.build_batch,
                         backend=args.build_backend)
        how = f"batched/{args.build_backend} (micro-batch {args.build_batch})"
    else:
        for v, a in zip(wl.vectors, wl.attrs):
            idx.insert(v, a)
        how = "sequential"
    sync()
    build_s = time.time() - t0
    build_launches = since(before)
    arena_bytes = idx._arena.nbytes() if idx._arena is not None else 0
    print(f"indexed {len(idx)} vectors in {build_s:.1f}s [{how}] "
          f"({args.n / build_s:.0f} inserts/s, {idx.graph.num_layers} "
          f"layers, {idx.memory_bytes()/2**20:.1f} MiB host, device arena "
          f"{arena_bytes/2**20:.1f} MiB, launches {build_launches})")
    snap = take_snapshot(idx)
    metric = "l2" if snap.metric == "l2" else "cosine"

    B = args.queries
    q, r = pad_queries(torch.as_tensor(wl.queries, device=dev),
                       torch.as_tensor(wl.ranges, dtype=torch.float32,
                                       device=dev))
    out = {
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n": args.n, "dim": args.dim, "queries": B,
        "build_backend": args.build_backend, "build_s": build_s,
        "inserts_per_s": args.n / build_s, "build_launches": build_launches,
        "build_stats": idx.build_stats, "arena_bytes": arena_bytes,
        "layers": idx.graph.num_layers, "runs": [],
        "snapshot": snap, "workload": wl, "index": idx,
    }

    def serve_all(snap, warm: bool, tag: str) -> list[dict]:
        runs = []
        for vec_dtype in args.vec_dtype:
            t0 = time.time()
            di = to_device_index(snap, vec_dtype=vec_dtype, device=dev)
            sync()
            upload_s = time.time() - t0
            for pipeline, visited, compact, backend in itertools.product(
                    args.pipeline, args.visited, compacts, args.backend):
                def serve():
                    return device_search(
                        di, q, r, k=args.k, width=args.width, m=snap.m,
                        o=snap.o, metric=metric, backend=backend,
                        pipeline=pipeline, visited=visited,
                        visited_bits=args.visited_bits, compact=compact)

                if warm:
                    serve()  # warm-up batch (first-use costs, kernel build)
                before = launches()
                sync()
                t0 = time.perf_counter()
                res = serve()  # returns host arrays: the batch has finished
                seconds = time.perf_counter() - t0
                n_launch = since(before)
                ids = res.ids[:B]
                recs = [recall(np.asarray([int(snap.ids_map[j])
                                           for j in ids[i] if j >= 0]),
                               wl.gt[i]) for i in range(B)]
                hops = res.hops[:B]
                p50, p99 = np.percentile(hops, [50, 99])
                run = {
                    "vec_dtype": vec_dtype, "pipeline": pipeline,
                    "visited": visited, "compact": compact,
                    "backend": backend,
                    "recall": float(np.mean(recs)),
                    "mean_dc": float(np.mean(res.dc[:B])),
                    "mean_hops": float(np.mean(hops)),
                    "hops_p50": float(p50), "hops_p99": float(p99),
                    "hops_max": int(hops.max()) if B else 0,
                    "seconds": seconds, "qps": B / seconds,
                    "upload_s": upload_s, "launches": n_launch,
                    "result": res._replace(ids=ids, dists=res.dists[:B],
                                           dc=res.dc[:B], hops=hops),
                }
                runs.append(run)
                print(f"{tag}[{vec_dtype} {pipeline} {visited} "
                      f"compact={compact} {backend}] served {B} queries: "
                      f"recall@{args.k} = {run['recall']:.4f}, mean DC = "
                      f"{run['mean_dc']:.0f}, hops p50={p50:.0f} "
                      f"p99={p99:.0f} max={run['hops_max']}, "
                      f"{run['qps']:.0f} QPS ({seconds*1e3:.1f} ms/batch), "
                      f"launches {n_launch}")
        return runs

    out["runs"] = serve_all(snap, warm=True, tag="")

    if args.ingest > 0:
        # ingest-while-serve: micro-batch inserts on the build backend +
        # incremental snapshot refresh (block-copied prefixes + dirty-row
        # scatters), then re-serve.  The new vectors' attributes lie above
        # every query range, so the ground truth is unchanged.
        extra_v = make_vectors(args.ingest, args.dim, seed=99)
        extra_a = make_attrs(extra_v, seed=99) + float(np.max(wl.attrs)) + 1.0
        before = launches()
        t0 = time.time()
        idx.insert_batch(extra_v, extra_a, batch_size=args.build_batch or 128,
                         backend=args.build_backend)
        sync()
        t_ing = time.time() - t0
        ingest_launches = since(before)
        t0 = time.time()
        snap = take_snapshot(idx, prev=snap)
        t_snap = time.time() - t0
        print(f"ingested {args.ingest} vectors in {t_ing:.2f}s "
              f"({args.ingest / max(t_ing, 1e-9):.0f} ins/s, launches "
              f"{ingest_launches}), incremental snapshot refresh "
              f"{t_snap * 1e3:.0f} ms ({snap.n} live)")
        out.update(ingest_s=t_ing, ingest_launches=ingest_launches,
                   snapshot_s=t_snap, snapshot_after=snap)
        out["ingest_runs"] = serve_all(snap, warm=False, tag="post-ingest ")
    return out


if __name__ == "__main__":
    main()
