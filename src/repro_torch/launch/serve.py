"""Serving launcher: build a WoW index on the host, upload its snapshot to
the device once, and serve batched range-filtered queries through the
device hop loop (``repro_torch.core.device_search``).

    PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --queries 256
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 1200 --dim 16

``--vec-dtype``, ``--visited``, ``--compact`` and ``--backend`` each take one
or more values; every combination is served over the one build (the host
build dominates the run time), each as one warm-up batch and one timed
batch.  ``main(argv)`` also returns what it printed — per configuration the
recall, mean DC, hop percentiles, QPS, the ``gather_norm_dot`` launches of
the timed batch and the raw results — with the snapshot and workload it
served.
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
                         "inside the gather kernel")
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
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    compacts = [_parse_compact(c) for c in args.compact]

    import numpy as np
    import torch

    from .. import resolve_device
    from ..core import WoWIndex, make_workload, recall
    from ..core.device_search import (
        device_search, pad_queries, to_device_index,
    )
    from ..core.snapshot import take_snapshot
    from ..kernels.gather_distance import LAUNCHES

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    wl = make_workload(n=args.n, d=args.dim, nq=args.queries, seed=0,
                       k=args.k)
    idx = WoWIndex(dim=args.dim, m=args.m,
                   ef_construction=args.ef_construction, o=args.o, seed=0)
    t0 = time.time()
    if args.build_batch > 0:
        idx.insert_batch(wl.vectors, wl.attrs, batch_size=args.build_batch)
        how = f"batched/numpy (micro-batch {args.build_batch})"
    else:
        for v, a in zip(wl.vectors, wl.attrs):
            idx.insert(v, a)
        how = "sequential"
    build_s = time.time() - t0
    print(f"indexed {len(idx)} vectors in {build_s:.1f}s [{how}] "
          f"({idx.graph.num_layers} layers, "
          f"{idx.memory_bytes()/2**20:.1f} MiB)")
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
        "build_s": build_s, "layers": idx.graph.num_layers, "runs": [],
        "snapshot": snap, "workload": wl,
    }
    for vec_dtype in args.vec_dtype:
        t0 = time.time()
        di = to_device_index(snap, vec_dtype=vec_dtype, device=dev)
        sync()
        upload_s = time.time() - t0
        for visited, compact, backend in itertools.product(
                args.visited, compacts, args.backend):
            def serve():
                return device_search(
                    di, q, r, k=args.k, width=args.width, m=snap.m,
                    o=snap.o, metric=metric, backend=backend,
                    visited=visited, visited_bits=args.visited_bits,
                    compact=compact)

            serve()  # warm-up batch (first-use costs, kernel build)
            before = LAUNCHES["gather_norm_dot"]
            sync()
            t0 = time.perf_counter()
            res = serve()  # returns host arrays: the batch has finished
            seconds = time.perf_counter() - t0
            launches = LAUNCHES["gather_norm_dot"] - before
            ids = res.ids[:B]
            recs = [recall(np.asarray([int(snap.ids_map[j])
                                       for j in ids[i] if j >= 0]),
                           wl.gt[i]) for i in range(B)]
            hops = res.hops[:B]
            p50, p99 = np.percentile(hops, [50, 99])
            run = {
                "vec_dtype": vec_dtype, "visited": visited,
                "compact": compact, "backend": backend,
                "recall": float(np.mean(recs)),
                "mean_dc": float(np.mean(res.dc[:B])),
                "mean_hops": float(np.mean(hops)),
                "hops_p50": float(p50), "hops_p99": float(p99),
                "hops_max": int(hops.max()) if B else 0,
                "seconds": seconds, "qps": B / seconds,
                "upload_s": upload_s, "launches": launches,
                "result": res._replace(ids=ids, dists=res.dists[:B],
                                       dc=res.dc[:B], hops=hops),
            }
            out["runs"].append(run)
            print(f"[{vec_dtype} {visited} compact={compact} {backend}] "
                  f"served {B} queries: recall@{args.k} = "
                  f"{run['recall']:.4f}, mean DC = {run['mean_dc']:.0f}, "
                  f"hops p50={p50:.0f} p99={p99:.0f} "
                  f"max={run['hops_max']}, {run['qps']:.0f} QPS "
                  f"({seconds*1e3:.1f} ms/batch), gather_norm_dot "
                  f"launches {launches}")
    return out


if __name__ == "__main__":
    main()
