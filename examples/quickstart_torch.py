"""Quickstart on the PyTorch port: build a WoW index incrementally, run
range-filtered queries, compare against exact ground truth, take a device
snapshot and serve a batch — the port's counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 1000

The index is built one insert at a time on the host (Algorithm 1); the
batch is served by the device hop loop (``search_batch``) on ``--device``,
through the CUDA kernels on the card.  ``--n``, ``--dim`` and
``--queries`` cut the workload.  ``main`` returns what it printed.
"""
import argparse
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the served batch (default: cuda)")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=50)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.core import WoWIndex, make_workload, recall
    from repro_torch.core.device_search import search_batch
    from repro_torch.core.snapshot import take_snapshot

    dev = resolve_device(args.device)
    print("=== WoW quickstart (PyTorch port) ===")
    wl = make_workload(n=args.n, d=args.dim, nq=args.queries, seed=0, k=10)

    idx = WoWIndex(dim=args.dim, m=16, ef_construction=64, o=4, seed=0)
    t0 = time.time()
    for v, a in zip(wl.vectors, wl.attrs):
        idx.insert(v, a)
    print(f"built incrementally: {idx.describe()} in {time.time()-t0:.1f}s")

    recs, dcs = [], []
    t0 = time.time()
    for i in range(len(wl.queries)):
        ids, _, st = idx.search(wl.queries[i], tuple(wl.ranges[i]), k=10,
                                ef=64)
        recs.append(recall(ids, wl.gt[i]))
        dcs.append(st.dc)
    qps = len(wl.queries) / (time.time() - t0)
    out = {"host_recall": float(np.mean(recs)), "host_dc": float(np.mean(dcs))}
    print(f"host search : recall@10={out['host_recall']:.4f}  "
          f"DC={out['host_dc']:.0f}  QPS={qps:.0f}")

    snap = take_snapshot(idx)
    res = search_batch(snap, wl.queries, wl.ranges, k=10, width=64,
                       device=dev)
    recs_dev = []
    for i in range(len(wl.queries)):
        ids = [int(snap.ids_map[j]) for j in res.ids[i] if j >= 0]
        recs_dev.append(recall(np.asarray(ids), wl.gt[i]))
    out["device_recall"] = float(np.mean(recs_dev))
    out["device_dc"] = float(np.mean(res.dc))
    print(f"device batch on {dev}: recall@10={out['device_recall']:.4f}  "
          f"mean DC={out['device_dc']:.0f}")

    # live insertion keeps serving correct: add vectors, re-snapshot, re-query
    extra = make_workload(n=200, d=args.dim, nq=1, seed=9, with_gt=False)
    for v, a in zip(extra.vectors, extra.attrs + 1e6):  # new attribute region
        idx.insert(v, a)
    ids, _, _ = idx.search(extra.vectors[0], (1e6, 2e6), k=5, ef=32)
    out["new_region_ids"] = ids[:5]
    print(f"after streaming 200 inserts: 5-NN in new attr region -> "
          f"{ids[:5]}")
    return out


if __name__ == "__main__":
    main()
