"""Serving launcher: build a WoW index (on the host, or on the device with
``--build-backend device``), upload its snapshot to the device once, and
serve batched range-filtered queries through the device hop loop
(``repro_torch.core.device_search``), or through the request-lifecycle
engine (``--engine``, ``repro_torch.serve.lifecycle``).

    PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --queries 256
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 1200 --dim 16
    PYTHONPATH=src python -m repro_torch.launch.serve --build-backend device \\
        --pipeline fused reference --ingest 400
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --rate 500 \\
        --deadline-ms 50 --ingest 400
    PYTHONPATH=src python -m repro_torch.launch.serve --index-dir /tmp/wow
    PYTHONPATH=src python -m repro_torch.launch.serve --cluster 3 \\
        --build-backend device --n 4000 --queries 256
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --build-backend sharded --mesh 2x1 --device cpu

``--vec-dtype``, ``--pipeline``, ``--visited``, ``--compact`` and
``--backend`` each take one or more values; every combination is served
over the one build (the build dominates the run time), each as one warm-up
batch and one timed batch.  ``--ingest N`` then streams N more vectors
through ``insert_batch`` on the build backend, refreshes the snapshot
incrementally (``take_snapshot(prev=...)``) and re-serves every
combination once (with ``--visited hash --adaptive-filter``, the hash
filter re-sized from the first wave's measured hop counts).  ``main(argv)``
also returns what it printed — the build's rate and kernel launches, per
configuration the recall, mean DC, hop percentiles, QPS, the kernel
launches of the timed batch and the raw results — with the snapshots and
workload it served.

``--engine`` serves one configuration (one value of each knob; the engine
sets its own chunk schedule, so no ``--compact``) through ``ServeEngine``:
the queries are admitted open-loop at ``--rate`` or as a closed burst,
with ``--deadline-ms``, ``--max-wave`` and ``--queue-cap``, and ``--ingest``
rides the engine's ingest queue.  ``main`` then returns the engine's run
under ``"engine"`` (``_serve_engine``).

``--index-dir`` is the durable lifecycle (``repro_torch.persist``): a
directory that holds checkpoints is served by a cold start off the newest
one (memory-mapped slabs, no rebuild; ``out["cold_start"]`` holds the
seconds to map and to the first reply), and a later ``--ingest`` first
recovers the live index (checkpoint + WAL replay) and rides its log;
otherwise the index is built with every micro-batch logged, then
checkpointed there.  After an ingest the index is checkpointed again
(incrementally).  ``--compact-rows`` runs the tombstone compaction pass
after the build, ``--compact-threshold`` sets the auto-compaction cadence.

``--build-backend sharded`` splits the device build's searches over the
ranks of a build mesh (``--build-shards N``; default: every rank), and
``--mesh DxM`` serves one configuration (one value of each knob, the
lock-step loop) through ``core.distributed.make_serving_fn`` on a
``(data, model)`` mesh of D x M ranks, printing the JAX launcher's recall,
mean-DC and hop lines; ``main`` returns that run under ``"mesh"``.  Under
``torchrun`` every rank runs ``main`` (gloo joins the ranks; only rank 0
prints); outside it, ``--build-shards 1`` and ``--mesh 1x1`` run in this
one process.

``--trace-compiles`` prints every CUDA-graph capture and kernel-library
build or load of the run to stderr as it happens
(``repro_torch.analysis.compile_guard.trace_compiles``).

``--cluster N`` is replicated serving (``repro_torch.serve.cluster``), a
mode of its own beside the one-shot runs and ``--engine``: N members
(a primary and N-1 replicas, one durable root each under ``--index-dir``
or a temporary directory) on ``--device``; the workload is ingested
through the primary with quorum-durable acks (``--cluster-quorum``
members, the primary included; 0 = a majority), the query stream is
routed across the members, and every member is restarted one at a time a
third of the way through it (``_serve_cluster``).  The run fails when a
query vanishes without a reply.
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


def _parser() -> argparse.ArgumentParser:
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
                    choices=("numpy", "ops", "device", "sharded"),
                    help="insert_batch phase-1 engine: host BLAS (numpy), "
                         "host search + fused gather kernel (ops), the "
                         "device-resident build — the hop pipeline over the "
                         "frozen snapshot + delta arena (device) — or that "
                         "build split over the ranks of a build mesh "
                         "(sharded; see --build-shards)")
    ap.add_argument("--build-shards", type=int, default=0,
                    help="with --build-backend sharded: build-mesh size "
                         "(0 = every rank of the torchrun world)")
    ap.add_argument("--mesh", default="",
                    help='query-sharded serving on a (data, model) mesh of '
                         'ranks, e.g. "2x1" (torchrun --nproc-per-node 2); '
                         "one configuration, the lock-step loop")
    ap.add_argument("--ingest", type=int, default=0,
                    help="ingest-while-serve: after the first serve wave, "
                         "stream N extra vectors through insert_batch, "
                         "refresh the snapshot incrementally and re-serve "
                         "the queries")
    ap.add_argument("--adaptive-filter", action="store_true",
                    help="with --visited hash: re-size the visited filter "
                         "for the post-ingest re-serve from the measured "
                         "hop counts of the first wave (p99 + slack; "
                         "worst-case sizing stays the cold-start default); "
                         "with --engine, from the engine's live hop "
                         "histogram (and the chunk schedule with it)")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the request-lifecycle engine "
                         "(repro_torch.serve.lifecycle): admission queue, "
                         "deadlines, backpressure, degraded replies; "
                         "--ingest rides the engine's ingest queue")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="with --engine: open-loop arrival rate in "
                         "queries/s (0 = submit everything at once, a "
                         "closed burst)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="with --engine: per-request deadline; requests "
                         "that cannot finish in time complete degraded "
                         "(reduced hop budget), never time out")
    ap.add_argument("--max-wave", type=int, default=64,
                    help="with --engine: widest scheduled wave")
    ap.add_argument("--queue-cap", type=int, default=512,
                    help="with --engine: admission-queue bound; submits "
                         "past it are rejected with a retry-after hint")
    ap.add_argument("--compact-rows", action="store_true",
                    help="run the tombstone compaction pass "
                         "(WoWIndex.compact_rows) before serving")
    ap.add_argument("--index-dir", default="",
                    help="durable lifecycle root: serve-from-checkpoint cold "
                         "start when the directory holds checkpoints (mapped "
                         "slabs, no rebuild), otherwise build the index "
                         "durably (WAL-logged ingest) and checkpoint it there")
    ap.add_argument("--compact-threshold", type=float, default=None,
                    help="background compaction cadence: run compact_rows "
                         "automatically once the tombstone fraction reaches "
                         "this value (checked at insert_batch and "
                         "checkpoint boundaries)")
    ap.add_argument("--cluster", type=int, default=0,
                    help="replicated serving: run N members (primary + N-1 "
                         "replicas, WAL shipping + quorum-durable ingest "
                         "acks), route the query stream across them, and "
                         "demonstrate a zero-downtime rolling restart "
                         "mid-stream (drain -> checkpoint -> restart -> "
                         "catch-up -> readmit, one member at a time); "
                         "roots live under --index-dir (or a temp dir)")
    ap.add_argument("--cluster-quorum", type=int, default=0,
                    help="with --cluster: members (primary included) that "
                         "must fsync before an ingest ack (0 = majority)")
    ap.add_argument("--device", default=None,
                    help="torch device to build and serve on (default: "
                         "cuda)")
    ap.add_argument("--trace-compiles", action="store_true",
                    help="print every CUDA-graph capture and kernel-library "
                         "build or load to stderr as it happens (wowlint "
                         "capture guard): a capture after warmup is a "
                         "shape-stability bug, visible here as a "
                         "timestamped line instead of a silent p99 spike")
    return ap


def _join_ranks() -> int:
    """Under ``torchrun`` (WORLD_SIZE > 1) join the ranks' default group
    (gloo: every collective of the port is a host gather) -> this rank."""
    import os

    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 0
    if not dist.is_initialized():
        dist.init_process_group("gloo")
    return dist.get_rank()


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` and run; under ``torchrun`` every rank runs this and
    only rank 0 prints."""
    import contextlib
    import io

    ap = _parser()
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.trace_compiles:
            from ..analysis.compile_guard import trace_compiles

            stack.enter_context(trace_compiles("launch.serve"))
        if _join_ranks():
            stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        return _main(ap, args)


def _main(ap: argparse.ArgumentParser, args) -> dict:
    if args.cluster > 1 and args.engine:
        ap.error("--cluster and --engine are one mode or the other: every "
                 "cluster member already serves through its own engine")
    if args.mesh and (args.engine or args.cluster > 1):
        ap.error("--mesh and --engine/--cluster are one mode or the other "
                 "(the engine schedules waves itself)")
    if args.build_shards > 0 and args.build_backend != "sharded":
        ap.error("--build-shards requires --build-backend sharded")
    if args.engine or args.cluster > 1 or args.mesh:
        mode = ("--engine" if args.engine else
                "--cluster" if args.cluster > 1 else "--mesh")
        many = [f"--{k.replace('_', '-')}" for k in
                ("vec_dtype", "visited", "backend")
                if len(getattr(args, k)) > 1]
        if many:
            ap.error(f"{mode} serves one configuration: one value of "
                     f"{', '.join(many)}")
        if args.compact != ["none"]:
            ap.error("--mesh runs the lock-step loop (no --compact)"
                     if args.mesh else
                     f"{mode} sets its own chunk schedule (no --compact)")
        if args.mesh and args.ingest:
            ap.error("--mesh serves one wave (no --ingest)")
        if args.mesh and len(args.pipeline) > 1:
            ap.error("--mesh serves one configuration: one value of "
                     "--pipeline")
        if not args.mesh and args.pipeline != ["fused"]:
            ap.error(f"{mode} runs the fused pipeline")
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
        visited_filter_bits_measured,
    )
    from ..core.snapshot import take_snapshot
    from ..kernels import launch_counters

    if torch.distributed.is_initialized():  # a rank's own card
        from ..parallel.sharding import rank_device

        dev = rank_device(args.device)
    else:
        dev = resolve_device(args.device)
    counters = launch_counters()
    build_kw = ({"shards": args.build_shards} if args.build_shards > 0
                else {})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def launches() -> dict:
        return {k: v for c in counters for k, v in c.items()}

    def since(before: dict) -> dict:
        return {k: v - before[k] for k, v in launches().items()}

    wl = make_workload(n=args.n, d=args.dim, nq=args.queries, seed=0,
                       k=args.k)
    if args.cluster > 1:
        return _serve_cluster(args, wl, dev)
    # one --vec-dtype builds at that storage mode, as the JAX launcher does
    build_dtype = args.vec_dtype[0] if len(args.vec_dtype) == 1 else "f32"
    idx = snap = cold = None
    if args.index_dir:
        from ..persist import (
            is_durable_dir, load_serving_snapshot, open_durable,
        )

        if is_durable_dir(args.index_dir):
            # serve-from-checkpoint cold start: the serving snapshot comes
            # straight off the newest checkpoint's mapped slabs — no host
            # index, no graph replay
            cold_t0 = time.time()
            snap, meta = load_serving_snapshot(args.index_dir)
            cold = {"t0": cold_t0, "map_s": time.time() - cold_t0,
                    "lsn": meta["lsn"]}
            print(f"cold start from {args.index_dir}: {snap.n} vectors "
                  f"(checkpoint lsn {meta['lsn']}) mapped in "
                  f"{cold['map_s'] * 1e3:.0f} ms")
        else:
            idx = open_durable(
                args.index_dir,
                create=dict(dim=args.dim, m=args.m,
                            ef_construction=args.ef_construction, o=args.o,
                            seed=0, vec_dtype=build_dtype),
                compact_threshold=args.compact_threshold, device=dev)
    else:
        idx = WoWIndex(dim=args.dim, m=args.m,
                       ef_construction=args.ef_construction, o=args.o,
                       seed=0, compact_threshold=args.compact_threshold,
                       vec_dtype=build_dtype, device=dev)
    out = {
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n": args.n, "dim": args.dim, "queries": args.queries,
        "build_backend": args.build_backend, "runs": [],
        "workload": wl, "cold_start": cold,
    }
    if idx is not None:
        before = launches()
        t0 = time.time()
        if args.build_batch > 0:
            idx.insert_batch(wl.vectors, wl.attrs,
                             batch_size=args.build_batch,
                             backend=args.build_backend, **build_kw)
            how = (f"batched/{args.build_backend} (micro-batch "
                   f"{args.build_batch})")
        else:
            for v, a in zip(wl.vectors, wl.attrs):
                idx.insert(v, a)
            how = "sequential"
        if args.index_dir:
            how += ", WAL-logged"
        sync()
        build_s = time.time() - t0
        build_launches = since(before)
        arena_bytes = idx._arena.nbytes() if idx._arena is not None else 0
        print(f"indexed {len(idx)} vectors in {build_s:.1f}s [{how}] "
              f"({args.n / build_s:.0f} inserts/s, {idx.graph.num_layers} "
              f"layers, {idx.memory_bytes()/2**20:.1f} MiB host, device "
              f"arena {arena_bytes/2**20:.1f} MiB, launches "
              f"{build_launches})")
        out.update(build_s=build_s, inserts_per_s=args.n / build_s,
                   build_launches=build_launches,
                   build_stats=idx.build_stats, arena_bytes=arena_bytes,
                   layers=idx.graph.num_layers)
        if args.compact_rows:
            t0 = time.time()
            nrows = idx.compact_rows()
            print(f"compact_rows: {nrows} rows rebuilt in "
                  f"{time.time() - t0:.2f}s")
        if args.index_dir:
            t0 = time.time()
            path = idx.checkpoint(args.index_dir)
            print(f"checkpointed to {path} in "
                  f"{(time.time() - t0) * 1e3:.0f} ms")
        snap = take_snapshot(idx)
    out.update(snapshot=snap, index=idx)
    metric = "l2" if snap.metric == "l2" else "cosine"

    B = args.queries
    q, r = pad_queries(torch.as_tensor(wl.queries, device=dev),
                       torch.as_tensor(wl.ranges, dtype=torch.float32,
                                       device=dev))

    if args.engine:
        out["engine"] = _serve_engine(args, wl, idx, snap, dev)
        return out
    if args.mesh:
        out["mesh"] = _serve_mesh(args, wl, snap, dev)
        return out

    def serve_all(snap, warm: bool, tag: str, first=None) -> list[dict]:
        """Serve every combination; ``first`` (the pre-ingest runs) feeds
        the adaptive filter its measured hop counts."""
        runs = []
        for vec_dtype in args.vec_dtype:
            t0 = time.time()
            di = to_device_index(snap, vec_dtype=vec_dtype, device=dev)
            sync()
            upload_s = time.time() - t0
            for pipeline, visited, compact, backend in itertools.product(
                    args.pipeline, args.visited, compacts, args.backend):
                v_bits = args.visited_bits
                if first is not None and args.adaptive_filter \
                        and visited == "hash":
                    prev = next(r for r in first if (
                        r["vec_dtype"], r["pipeline"], r["visited"],
                        r["compact"], r["backend"]) == (
                        vec_dtype, pipeline, visited, compact, backend))
                    v_bits = visited_filter_bits_measured(
                        prev["result"].hops, args.m)
                    print(f"adaptive visited filter: {v_bits} bits/query "
                          f"from the measured hop counts (p99="
                          f"{prev['hops_p99']:.0f})")

                def serve(v_bits=v_bits):
                    return device_search(
                        di, q, r, k=args.k, width=args.width, m=snap.m,
                        o=snap.o, metric=metric, backend=backend,
                        pipeline=pipeline, visited=visited,
                        visited_bits=v_bits, compact=compact)

                if warm:
                    serve()  # warm-up batch (first-use costs, kernel build)
                    if cold is not None and "first_reply_s" not in cold:
                        cold["first_reply_s"] = time.time() - cold["t0"]
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
                    "backend": backend, "visited_bits": v_bits,
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
    if cold is not None:  # the first warm-up batch was the first reply
        print(f"cold-start-to-first-query: "
              f"{cold['first_reply_s'] * 1e3:.0f} ms (load + serve wave)")

    if args.ingest > 0:
        # ingest-while-serve: micro-batch inserts on the build backend +
        # incremental snapshot refresh (block-copied prefixes + dirty-row
        # scatters), then re-serve.  The new vectors' attributes lie above
        # every query range, so the ground truth is unchanged.
        extra_v = make_vectors(args.ingest, args.dim, seed=99)
        extra_a = make_attrs(extra_v, seed=99) + float(np.max(wl.attrs)) + 1.0
        if idx is None:
            # cold-started off the checkpoint: ingest needs the live index
            # — run full crash recovery (checkpoint + WAL replay) now and
            # ride the WAL from here on
            t0 = time.time()
            idx = open_durable(args.index_dir,
                               compact_threshold=args.compact_threshold,
                               device=dev)
            print(f"recovered live index for ingest in "
                  f"{time.time() - t0:.2f}s ({len(idx)} vectors, lsn "
                  f"{idx._applied_lsn})")
            out["index"] = idx
        before = launches()
        t0 = time.time()
        idx.insert_batch(extra_v, extra_a, batch_size=args.build_batch or 128,
                         backend=args.build_backend, **build_kw)
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
        out["ingest_runs"] = serve_all(snap, warm=False, tag="post-ingest ",
                                       first=out["runs"])
        if args.index_dir:
            # the WAL already made the ingest durable; the incremental
            # checkpoint (O(changed rows)) just shortens the next replay
            t0 = time.time()
            path = idx.checkpoint(args.index_dir)
            print(f"incremental checkpoint to {path} in "
                  f"{(time.time() - t0) * 1e3:.0f} ms")
    return out


def _serve_mesh(args, wl, snap, device) -> dict:
    """Query-sharded serving (``core.distributed.make_serving_fn``) on a
    ``(data, model)`` mesh of ranks: one wave of the workload's queries,
    printed as the JAX launcher prints it.  Returns the mesh, the result,
    recall, seconds, QPS, the serving function's state and the kernel
    launches of the wave (this rank's)."""
    import numpy as np

    from ..core import recall
    from ..core.distributed import make_serving_fn
    from ..kernels import launch_counters
    from ..parallel import serving_mesh

    def launches() -> dict:
        return {k: v for c in launch_counters() for k, v in c.items()}

    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = serving_mesh(d, m, device=device)
    serve = make_serving_fn(
        mesh, snap, k=args.k, width=args.width, backend=args.backend[0],
        pipeline=args.pipeline[0], visited=args.visited[0],
        visited_bits=args.visited_bits,
        visited_adaptive=args.adaptive_filter, vec_dtype=args.vec_dtype[0])
    before = launches()
    t0 = time.perf_counter()
    res = serve(wl.queries, wl.ranges)
    seconds = time.perf_counter() - t0
    n_launch = {k: v - before[k] for k, v in launches().items()}
    if args.adaptive_filter and args.visited[0] == "hash":
        print(f"adaptive visited filter (sharded, gathered hop histogram): "
              f"{serve.state['bits']} bits/query after "
              f"{int(serve.state['hist'].sum())} queries")
    recs = [recall(np.asarray([int(snap.ids_map[j]) for j in res.ids[i]
                               if j >= 0]), wl.gt[i])
            for i in range(args.queries)]
    hops = res.hops
    print(f"served {args.queries} queries: recall@{args.k} = "
          f"{np.mean(recs):.4f}, mean DC = {float(np.mean(res.dc)):.0f}, "
          f"mean hops = {float(np.mean(hops)):.0f}")
    q = np.percentile(hops, [50, 90, 99, 100]).astype(int)
    print(f"hops-to-termination: p50={q[0]} p90={q[1]} p99={q[2]} "
          f"max={q[3]} (ragged batches pay max without --compact)")
    return {"shape": (d, m), "rank": mesh.rank, "result": res,
            "recall": float(np.mean(recs)), "seconds": seconds,
            "qps": args.queries / seconds, "state": serve.state,
            "launches": n_launch}


def _serve_cluster(args, wl, device) -> dict:
    """Replicated serving: ingest the workload through the primary
    (quorum-durable acks), serve the query stream across every member,
    and run a zero-downtime rolling restart a third of the way through it.
    The stream must complete with zero vanished queries (degraded is
    fine); ``SystemExit`` otherwise.  Returns what it printed: the
    replicas' lag after the ingest, recall, QPS, replies by member, the
    rolling restart's events and seconds, the primary and its epoch."""
    import os
    import tempfile

    import numpy as np

    from ..core import recall
    from ..serve.cluster import Cluster
    from ..serve.lifecycle import EngineConfig, Rejected

    base = args.index_dir or tempfile.mkdtemp(prefix="wow-cluster-")
    roots = [os.path.join(base, f"member{i}") for i in range(args.cluster)]
    cfg = EngineConfig(
        k=args.k, width=args.width, backend=args.backend[0],
        visited=args.visited[0], visited_bits=args.visited_bits,
        adaptive=args.adaptive_filter, max_wave=args.max_wave,
        queue_cap=args.queue_cap,
        default_timeout_s=(args.deadline_ms / 1e3
                           if args.deadline_ms > 0 else None),
        build_backend=args.build_backend,
        vec_dtype=args.vec_dtype[0],
    )
    quorum = args.cluster_quorum or None
    cluster = Cluster(
        roots,
        create=dict(dim=args.dim, m=args.m,
                    ef_construction=args.ef_construction, o=args.o, seed=0),
        config=cfg, quorum=quorum,
        compact_threshold=args.compact_threshold, device=device)
    t0 = time.time()
    bs = max(args.build_batch or 128, 1)
    for s in range(0, args.n, bs):
        cluster.submit_ingest(wl.vectors[s:s + bs], wl.attrs[s:s + bs])
        cluster.step()
    cluster.drain()
    lag = {nid: m.replicator.status().get("lag", 0)
           for nid, m in cluster.members.items() if m.replicator is not None}
    print(f"cluster of {args.cluster} (quorum {cluster.quorum}) on "
          f"{cluster.device}: ingested {args.n} vectors in "
          f"{time.time() - t0:.1f}s, every ack quorum-durable, lag={lag}")
    cluster.warmup()

    replies = []
    rejected = 0
    crid_to_qi: dict[int, int] = {}
    restart_at = args.queries // 3
    rolled = None
    t0 = time.time()
    for i in range(args.queries):
        out = cluster.submit(wl.queries[i], wl.ranges[i])
        if isinstance(out, Rejected):
            rejected += 1
        else:
            crid_to_qi[out.crid] = i
        replies.extend(cluster.step())
        if i == restart_at:
            # every member restarts mid-stream; routing and the engines'
            # backpressure absorb it
            t_roll = time.time()
            res = cluster.rolling_restart()
            replies.extend(res["replies"])
            rolled = (res["events"], time.time() - t_roll)
    replies.extend(cluster.drain())
    wall = time.time() - t0

    recs = []
    by_node: dict[str, int] = {}
    degraded = 0
    for cr in replies:
        qi = crid_to_qi.get(cr.crid)
        if qi is None:
            continue
        got = np.asarray([j for j in cr.reply.ids if j >= 0])
        recs.append(recall(got, wl.gt[qi]))
        by_node[cr.node] = by_node.get(cr.node, 0) + 1
        degraded += int(cr.reply.degraded)
    if rolled is not None:
        ev, t_roll = rolled
        print(f"rolling restart mid-stream in {t_roll:.1f}s: "
              + ", ".join(f"{what}:{nid}" for what, nid in ev))
    rec = float(np.mean(recs)) if recs else 0.0
    qps = len(recs) / max(wall, 1e-9)
    print(f"served {len(recs)}/{args.queries} queries across "
          f"{by_node} (rejected {rejected}, degraded {degraded}): "
          f"recall@{args.k} = {rec:.4f}, {qps:.0f} QPS")
    lost = args.queries - len(recs) - rejected
    if lost:
        raise SystemExit(f"{lost} queries vanished without a reply — the "
                         f"zero-downtime contract is broken")
    epoch = cluster.members[cluster.primary_id].replicator.epoch
    print(f"zero-downtime contract held: every admitted query replied "
          f"(primary now {cluster.primary_id}, epoch {epoch})")
    return {
        "device": str(cluster.device), "lag": lag, "recall": rec,
        "qps": qps, "by_node": by_node, "rejected": rejected,
        "degraded": degraded,
        "rolling_restart": ({"events": rolled[0], "s": rolled[1]}
                            if rolled is not None else None),
        "primary": cluster.primary_id, "epoch": epoch,
    }


def _serve_engine(args, wl, idx, snap, device=None, ingest=None) -> dict:
    """Engine-driven serving: admit the workload through the request
    lifecycle (open-loop at ``args.rate`` or as a closed burst), drive the
    scheduler until it drains, print the latency percentiles and QPS
    (admission -> reply) and the shutdown summary, and return them.

    ``idx``/``snap`` are the index and its snapshot (an index built
    elsewhere may be served, as ``chip_smoke.py`` does); ``idx`` is None
    after a cold start off ``args.index_dir``, and an ingest then first
    recovers the live index with its log, and checkpoints it afterwards.  With
    ``args.ingest`` rows (``ingest`` = (vectors, attrs) to give them, else
    generated above every query range as the launcher's ingest does) are
    admitted through ``submit_ingest`` before traffic and applied between
    the query chunks.  The returned dict holds the replies in query order
    (``result``: ids, dists, dc, hops; ``degraded``, ``reason``), recall,
    latency, QPS, the engine's stats, the kernel launches and replayed
    graph chunks of the traffic (after warm-up), the captures during
    warm-up and after it, the graph cache before and after, the ingest
    rate and the snapshots served before and after."""
    import numpy as np
    import torch

    from ..core import recall
    from ..core.datasets import make_attrs, make_vectors
    from ..core.device_search import (
        GRAPH_CAPTURES, GRAPH_REPLAYS, KERNEL_REPLAYS, SearchResult,
        graph_cache_stats,
    )
    from ..kernels import launch_counters
    from ..serve.lifecycle import EngineConfig, Rejected, ServeEngine

    def counts() -> dict:
        out = {k: v for c in launch_counters() for k, v in c.items()}
        out.update({f"replayed_{k}": v for k, v in KERNEL_REPLAYS.items()})
        out.update({f"graph_{k}": v for k, v in GRAPH_REPLAYS.items()})
        out["captures"] = GRAPH_CAPTURES["chunks"]
        return out

    def since(before: dict) -> dict:
        return {k: v - before[k] for k, v in counts().items()}

    cfg = EngineConfig(
        k=args.k, width=args.width, backend=args.backend[0],
        visited=args.visited[0], visited_bits=args.visited_bits,
        adaptive=args.adaptive_filter, max_wave=args.max_wave,
        queue_cap=args.queue_cap,
        default_timeout_s=(args.deadline_ms / 1e3
                           if args.deadline_ms > 0 else None),
        build_backend=args.build_backend,
        vec_dtype=args.vec_dtype[0],
    )
    eng = ServeEngine(index=idx, snapshot=snap, config=cfg, device=device)
    dev = eng.device
    if args.ingest > 0 and idx is None:
        from ..persist import open_durable

        idx = open_durable(args.index_dir,
                           compact_threshold=args.compact_threshold,
                           device=dev)
        eng = ServeEngine(index=idx, config=cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_ingest = 0
    if args.ingest > 0:
        if ingest is None:
            extra_v = make_vectors(args.ingest, args.dim, seed=99)
            extra_a = (make_attrs(extra_v, seed=99)
                       + float(np.max(wl.attrs)) + 1.0)
        else:
            extra_v, extra_a = ingest
        ir = eng.submit_ingest(extra_v, extra_a)
        n_ingest = ir.accepted
        print(f"ingest admitted (applies interleave with queries): {ir!r}")

    graphs_before = graph_cache_stats()
    before = counts()
    warmup_s = eng.warmup()
    warm = since(before)
    print(f"engine warmup (all wave shapes) in {warmup_s:.2f} s, "
          f"{warm['captures']} chunks captured")
    snap_before = eng._snap

    replies: list = []
    rid_to_qi: dict = {}
    rejected = 0
    period = 1.0 / args.rate if args.rate > 0 else 0.0
    before = counts()
    t_loop = time.monotonic()
    next_t = t_loop
    ingest_done = None

    def note_ingest():
        nonlocal ingest_done
        if n_ingest and ingest_done is None and eng.pending_ingest == 0:
            ingest_done = time.monotonic()

    for i in range(args.queries):
        if period:
            # open-loop arrivals: hold the offered load fixed and keep the
            # scheduler busy between arrivals instead of sleeping idle
            while True:
                now = time.monotonic()
                if now >= next_t:
                    break
                if not eng.idle:
                    replies.extend(eng.step())
                    note_ingest()
                else:
                    time.sleep(min(1e-3, next_t - now))
            next_t += period
        out = eng.submit(wl.queries[i], wl.ranges[i])
        if isinstance(out, Rejected):
            rejected += 1
        else:
            rid_to_qi[out.rid] = i
        if period:
            replies.extend(eng.step())
            note_ingest()
        # closed burst: no step between submits, so the scheduler sees the
        # whole backlog and assembles full-width waves
    while not eng.idle:
        replies.extend(eng.step())
        note_ingest()
    sync()
    traffic = since(before)

    nq, k = len(wl.queries), args.k
    ids = np.full((nq, k), -1, np.int64)
    dists = np.full((nq, k), np.inf, np.float32)
    dc = np.zeros(nq, np.int64)
    hops = np.zeros(nq, np.int64)
    answered = np.zeros(nq, bool)
    degraded = np.zeros(nq, bool)
    reason: list = [None] * nq
    recs = []
    for r in replies:
        qi = rid_to_qi.get(r.rid)
        if qi is None:
            continue
        ids[qi], dists[qi], dc[qi], hops[qi] = r.ids, r.dists, r.dc, r.hops
        answered[qi], degraded[qi], reason[qi] = True, r.degraded, r.reason
        recs.append(recall(np.asarray([j for j in r.ids if j >= 0]),
                           wl.gt[qi]))
    s = eng.engine_stats()
    rec = float(np.mean(recs)) if recs else 0.0
    print(f"engine served {s['served']} queries "
          f"(admitted {s['admitted']}, rejected {rejected}, "
          f"degraded {s['degraded']}, expired-in-queue {s['expired']}): "
          f"recall@{k} = {rec:.4f}")
    print(f"latency admission->reply: p50={s['p50_ms']:.1f} ms "
          f"p95={s['p95_ms']:.1f} ms p99={s['p99_ms']:.1f} ms, "
          f"throughput {s['qps']:.0f} QPS"
          + (f" (offered {args.rate:.0f} QPS open-loop)"
             if period else " (closed burst)"))
    print(f"shutdown summary: waves={s['waves']} chunks={s['chunks']} "
          f"shed_waves={s['shed_waves']} queue_peak={s['queue_peak']} "
          f"ingest_batches={s['ingest']['batches']} "
          f"ingest_rows={s['ingest']['rows']} "
          f"chunk_schedule={s['chunk_schedule']} launches {traffic}")
    ingest_s = (ingest_done - t_loop) if ingest_done is not None else None
    if n_ingest:
        print(f"ingested {n_ingest} rows through the engine in "
              f"{ingest_s:.2f} s ({n_ingest / ingest_s:.1f} rows/s); "
              f"snapshot refreshed: {eng._snap is not snap_before}; "
              f"applied_lsn={s['applied_lsn']}")
        if args.index_dir:
            t0 = time.time()
            path = idx.checkpoint(args.index_dir)
            print(f"incremental checkpoint to {path} in "
                  f"{(time.time() - t0) * 1e3:.0f} ms")
    return {
        "config": cfg, "device": str(dev), "warmup_s": warmup_s,
        "warmup_counts": warm, "counts": traffic,
        "captures_after_warmup": traffic["captures"],
        "graphs_before": graphs_before, "graphs_after": graph_cache_stats(),
        "result": SearchResult(ids=ids, dists=dists, dc=dc, hops=hops),
        "answered": answered, "degraded": degraded, "reason": reason,
        "rejected": rejected, "recall": rec, "qps": s["qps"],
        "latency_ms": {q: s[f"{q}_ms"] for q in ("p50", "p95", "p99")},
        "stats": s, "ingest_rows": n_ingest, "ingest_s": ingest_s,
        "snapshot_refreshed": eng._snap is not snap_before,
    }


if __name__ == "__main__":
    main()
    import torch.distributed

    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
