"""The control of ``correct``: the reference put in the program's place and
computed one precision below the configuration's float32, at TF32 (the
inputs rounded to 10 mantissa bits, as a tensor-core float32 product reads
them; the products summed in float32), and held by ``reference.judge`` to
the same limits as a run.  It has to come out not correct.

    python -m wowbench.control --workload <cell> --seeds <n> [<n> ...]

makes each seed's inputs as a run of the cell does (the configuration's
base rows, the mix's queries and ingest rows from the seed), answers every
query set the run's replies are judged on (for an ingest mix over the
base and every ingest row the run can send) at TF32, and prints each
seed's numbers beside their limits and one JSON line of them all.  It
runs no part of the program.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import data, loadgen, reference, spec


def tf32_answers(vectors, attrs, queries, ranges, k: int, device):
    """Exact range-filtered k-NN from TF32-rounded inputs, in float32."""
    ids, dists = reference.exact_knn(
        reference.tf32(vectors), attrs, reference.tf32(queries), ranges, k,
        device=device, dtype=torch.float32)
    return ids, dists.astype(np.float32)


def readings(cfg: dict, mix: dict, seed: int, seconds: float,
             device) -> dict:
    """The control's checks on one seed's inputs."""
    k = cfg["search"]["k"]
    base = data.make_base(cfg["n"], cfg["d"], cfg["data_seed"], device)
    gen = loadgen.load_generator(mix["generator"])
    traffic = gen.Traffic(None, None, cfg, mix, base, seed, seconds,
                          device=device)
    vecs = base.vectors.cpu().numpy()
    attrs = base.attrs.cpu().numpy()
    if mix["ingest"]:
        vecs = np.concatenate([vecs, traffic.ingest_vectors])
        attrs = np.concatenate([attrs, traffic.ingest_attrs])
    out = {"correct": True, "checks": {}}
    for rs in traffic.replies():
        qs, ranges = rs["queries"], rs["ranges"]
        ids, dists = tf32_answers(vecs, attrs, qs, ranges, k, device)
        v = reference.judge(vecs, attrs, qs, ranges, np.arange(len(qs)), ids,
                            dists, k=k, limits=cfg["checks"], device=device,
                            recall_mask=rs["recall"])
        out["correct"] = out["correct"] and v["correct"]
        out["checks"].update({rs["prefix"] + c: x
                              for c, x in v["checks"].items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m wowbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    cfg = spec.load_config(cell["config"])
    mix = loadgen.load_mix(cell["traffic"])
    runs = []
    for seed in args.seeds:
        r = readings(cfg, mix, seed % 2**63, bench["run_seconds"], "cuda")
        r["seed"] = seed
        runs.append(r)
        print(f"control {args.workload} seed {seed}: correct {r['correct']}; "
              + ", ".join(f"{c} {x[0]!r} (limit {x[1]!r})"
                          for c, x in r["checks"].items()), file=sys.stderr)
    print(json.dumps({"workload": args.workload, "runs": runs}))
    return 0 if not any(r["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
