"""Streaming updates under load on the PyTorch port: interleave inserts,
deletions and queries — Challenge 1 (fully incremental, no rebuild, no
recall collapse), the port's counterpart of
``examples/incremental_updates.py``.

Replays the paper's DIGRA comparison scenario: build on 50% of the data,
stream the other 50%, verify recall holds (the paper reports DIGRA dropping
99% -> 27% in this setting; WoW is stable).  Then the durable lifecycle
(``repro_torch.persist``): checkpoint, keep ingesting through the
write-ahead log, crash mid-ingest, recover, and compare.

    PYTHONPATH=src python examples/incremental_updates_torch.py      # the card
    PYTHONPATH=src python examples/incremental_updates_torch.py --device cpu \\
        --build-backend numpy --n 1000

Every micro-batch's construction searches run on ``--build-backend``:
``device`` (the default) runs them through the device hop loop on
``--device``, the card by default; ``numpy`` is the host build the JAX
example uses.  ``--n``, ``--dim``, ``--queries`` and ``--stream-chunk``
cut the workload.  ``main`` returns the recalls it printed.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def eval_recall(idx, wl, k=10, ef=64):
    from repro_torch.core import brute_force, recall

    recs = []
    for i in range(len(wl.queries)):
        ids, _, _ = idx.search(wl.queries[i], tuple(wl.ranges[i]), k=k, ef=ef)
        gold = brute_force(
            idx.store.vectors[: idx.store.n], idx.store.attrs[: idx.store.n],
            wl.queries[i], tuple(wl.ranges[i]), k,
        )
        recs.append(recall(ids, gold))
    return float(np.mean(recs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the build (default: cuda)")
    ap.add_argument("--build-backend", default="device",
                    choices=("numpy", "ops", "device"))
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--dim", type=int, default=24)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--stream-chunk", type=int, default=500)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.core import WoWIndex, make_workload
    from repro_torch.persist import CrashError, FaultIO, open_durable, \
        state_digest

    dev = resolve_device(args.device)
    backend = args.build_backend
    wl = make_workload(n=args.n, d=args.dim, nq=args.queries, seed=0,
                       with_gt=False)
    half = len(wl.vectors) // 2
    kw = dict(dim=args.dim, m=16, ef_construction=64, o=4, seed=0)
    out = {"streamed": []}

    idx = WoWIndex(**kw, device=dev)
    t0 = time.perf_counter()
    idx.insert_batch(wl.vectors[:half], wl.attrs[:half], batch_size=128,
                     backend=backend)
    dt = time.perf_counter() - t0
    out["built"] = eval_recall(idx, wl)
    print(f"phase 1: batched build ({backend} on {dev}) on 50% ({half} "
          f"vectors, {half/dt:.0f} ins/s) -> recall {out['built']:.4f}")

    # stream the second half in micro-batches, querying every chunk
    step = args.stream_chunk
    for i in range(half, len(wl.vectors), step):
        chunk = slice(i, min(i + step, len(wl.vectors)))
        idx.insert_batch(wl.vectors[chunk], wl.attrs[chunk], batch_size=128,
                         backend=backend)
        out["streamed"].append(eval_recall(idx, wl))
        print(f"  streamed to {chunk.stop}: recall {out['streamed'][-1]:.4f}")
    out["after_stream"] = eval_recall(idx, wl)
    print(f"phase 2: after streaming the rest -> recall "
          f"{out['after_stream']:.4f}")

    # deletions: remove 5% and verify they disappear from results
    rng = np.random.default_rng(1)
    victims = rng.choice(idx.store.n, size=idx.store.n // 20, replace=False)
    for v in victims:
        idx.delete(int(v))
    bad = 0
    for i in range(len(wl.queries)):
        ids, _, _ = idx.search(wl.queries[i], tuple(wl.ranges[i]), k=10,
                               ef=64)
        bad += len(set(ids.tolist()) & set(victims.tolist()))
    out["deleted_in_results"] = bad
    out["after_delete"] = eval_recall(idx, wl)
    print(f"phase 3: deleted {len(victims)}; deleted ids in results: {bad} "
          f"(expected 0); recall {out['after_delete']:.4f}")

    # phase 4 — the durable lifecycle: checkpoint the index, continue
    # ingesting through the WAL, crash mid-ingest, recover, and verify the
    # recovered index answers with the same recall.  Every micro-batch is
    # logged-and-fsynced BEFORE it is applied, so the crash loses at most
    # the batch that was in flight.
    root = tempfile.mkdtemp(prefix="wow-durable-")
    try:
        dur = open_durable(root, create=kw, device=dev)
        dur.insert_batch(wl.vectors[:half], wl.attrs[:half], batch_size=128,
                         backend=backend)
        t0 = time.perf_counter()
        dur.checkpoint(root)
        print(f"phase 4: checkpointed {len(dur)} vectors in "
              f"{(time.perf_counter()-t0)*1e3:.0f} ms")

        # keep ingesting, then crash the process' io mid-batch (FaultIO
        # kills the writer after a byte budget — a simulated power cut)
        dur._wal.io = FaultIO(crash_after_bytes=40_000)
        try:
            for i in range(half, len(wl.vectors), 250):
                chunk = slice(i, min(i + 250, len(wl.vectors)))
                dur.insert_batch(wl.vectors[chunk], wl.attrs[chunk],
                                 batch_size=128, backend=backend)
        except CrashError:
            pass
        print(f"  crashed mid-ingest with {len(dur)} vectors applied "
              f"(durable: every fsynced micro-batch)")

        t0 = time.perf_counter()
        rec = WoWIndex.recover(root, device=dev)
        dt = time.perf_counter() - t0
        out["recovered"] = eval_recall(rec, wl)
        out["bitwise"] = state_digest(rec) == state_digest(dur)
        print(f"  recovered {len(rec)} vectors in {dt:.2f}s -> recall "
              f"{out['recovered']:.4f} (bitwise match: {out['bitwise']})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
