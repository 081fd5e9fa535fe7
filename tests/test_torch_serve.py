"""The slice as a whole: ``python -m repro_torch.launch.serve`` on the CPU
builds, snapshots, uploads and serves, and its answers are the JAX
package's ``search_batch`` answers over the reference-built index (the
tie rule of ``compare_results``).  Compacted runs equal their lock-step
twins bit for bit."""
import numpy as np

import repro.core as rc
from repro.core import device_search as rds
from repro.core.snapshot import take_snapshot as ref_take_snapshot
from repro_torch.core.device_search import SearchResult, compare_results
from repro_torch.launch import serve

ARGS = ["--device", "cpu", "--n", "1200", "--dim", "16", "--queries", "40",
        "--width", "32", "--m", "8", "--ef-construction", "32",
        "--vec-dtype", "f32", "int8", "--visited", "bitmap", "hash",
        "--compact", "none", "8,8"]


def test_serve_main_matches_jax(capsys):
    out = serve.main(ARGS)
    printed = capsys.readouterr().out
    assert printed.startswith("indexed 1200 vectors")
    runs = out["runs"]
    assert len(runs) == 8 and out["device"] == "cpu"
    wl = rc.make_workload(n=1200, d=16, nq=40, seed=0, k=10)
    ri = rc.WoWIndex(dim=16, m=8, ef_construction=32, o=4, seed=0)
    ri.insert_batch(wl.vectors, wl.attrs, batch_size=128)
    rsnap = ref_take_snapshot(ri)
    scale = float(rsnap.sq_norms.max() + (wl.queries**2).sum(1).max())
    lockstep = {}
    for run in runs:
        assert run["launches"] == 0  # CPU tensors take the plain version
        assert run["qps"] > 0 and 0.0 <= run["recall"] <= 1.0
        key = (run["vec_dtype"], run["visited"])
        if run["compact"] is not None:  # compaction changes no result
            for a, b in zip(run["result"], lockstep[key]["result"]):
                np.testing.assert_array_equal(a, b)
            continue
        lockstep[key] = run
        if run["visited"] != "bitmap":
            continue
        exp = rds.search_batch(rsnap, wl.queries, wl.ranges, k=10, width=32,
                               backend="ref", vec_dtype=run["vec_dtype"])
        exp = SearchResult(*(np.asarray(a) for a in exp))
        rep = compare_results(run["result"], exp, scale=scale)
        assert rep["faults"] == [] and not rep["tie_flips"], rep
        rec = np.mean([rc.recall(np.asarray([j for j in exp.ids[i] if j >= 0]),
                                 wl.gt[i]) for i in range(40)])
        assert run["recall"] == rec
    assert lockstep[("f32", "bitmap")]["recall"] >= 0.9
