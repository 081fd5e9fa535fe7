"""The port's WoW examples (``examples/quickstart_torch.py``,
``examples/incremental_updates_torch.py``) on the CPU at a reduced size,
their recall and distance-computation counts held to what the JAX package
gives for the same seeds, sizes and steps (the reference examples' own
steps, through ``repro``; the port's host build is the reference's, so
they agree exactly)."""
import importlib.util
import shutil
import tempfile
from pathlib import Path

import jax  # noqa: F401  (the reference side runs on JAX)
import numpy as np
import pytest

import repro.core as rc
import repro.persist as rp
from repro.core.device_search import search_batch as ref_search_batch
from repro.core.snapshot import take_snapshot as ref_take_snapshot

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_jax():
    n, d, nq = 500, 16, 20
    out = _example("quickstart_torch").main(
        ["--device", "cpu", "--n", str(n), "--dim", str(d), "--queries",
         str(nq)])
    wl = rc.make_workload(n=n, d=d, nq=nq, seed=0, k=10)
    idx = rc.WoWIndex(dim=d, m=16, ef_construction=64, o=4, seed=0)
    for v, a in zip(wl.vectors, wl.attrs):
        idx.insert(v, a)
    recs, dcs = [], []
    for i in range(nq):
        ids, _, st = idx.search(wl.queries[i], tuple(wl.ranges[i]), k=10,
                                ef=64)
        recs.append(rc.recall(ids, wl.gt[i]))
        dcs.append(st.dc)
    assert out["host_recall"] == float(np.mean(recs))
    assert out["host_dc"] == float(np.mean(dcs))
    snap = ref_take_snapshot(idx)
    res = ref_search_batch(snap, wl.queries, wl.ranges, k=10, width=64)
    recs_dev = [rc.recall(np.asarray([int(snap.ids_map[j])
                                      for j in np.asarray(res.ids[i])
                                      if j >= 0]), wl.gt[i])
                for i in range(nq)]
    assert out["device_recall"] == pytest.approx(float(np.mean(recs_dev)))
    assert out["device_dc"] == float(np.mean(np.asarray(res.dc)))
    extra = rc.make_workload(n=200, d=d, nq=1, seed=9, with_gt=False)
    for v, a in zip(extra.vectors, extra.attrs + 1e6):
        idx.insert(v, a)
    ids, _, _ = idx.search(extra.vectors[0], (1e6, 2e6), k=5, ef=32)
    np.testing.assert_array_equal(out["new_region_ids"], ids[:5])


def test_incremental_updates_matches_jax():
    n, d, nq, step = 600, 12, 10, 150
    out = _example("incremental_updates_torch").main(
        ["--device", "cpu", "--build-backend", "numpy", "--n", str(n),
         "--dim", str(d), "--queries", str(nq), "--stream-chunk", str(step)])
    eval_recall = _example("incremental_updates").eval_recall  # the JAX one
    wl = rc.make_workload(n=n, d=d, nq=nq, seed=0, with_gt=False)
    half = n // 2
    kw = dict(dim=d, m=16, ef_construction=64, o=4, seed=0)
    idx = rc.WoWIndex(**kw)
    idx.insert_batch(wl.vectors[:half], wl.attrs[:half], batch_size=128)
    want = {"built": eval_recall(idx, wl), "streamed": []}
    for i in range(half, n, step):
        chunk = slice(i, min(i + step, n))
        idx.insert_batch(wl.vectors[chunk], wl.attrs[chunk], batch_size=128)
        want["streamed"].append(eval_recall(idx, wl))
    want["after_stream"] = eval_recall(idx, wl)
    rng = np.random.default_rng(1)
    victims = rng.choice(idx.store.n, size=idx.store.n // 20, replace=False)
    for v in victims:
        idx.delete(int(v))
    want["after_delete"] = eval_recall(idx, wl)
    root = tempfile.mkdtemp(prefix="wow-durable-")
    try:
        dur = rp.open_durable(root, create=kw)
        dur.insert_batch(wl.vectors[:half], wl.attrs[:half], batch_size=128)
        dur.checkpoint(root)
        dur._wal.io = rp.FaultIO(crash_after_bytes=40_000)
        try:
            for i in range(half, n, 250):
                chunk = slice(i, min(i + 250, n))
                dur.insert_batch(wl.vectors[chunk], wl.attrs[chunk],
                                 batch_size=128)
        except rp.CrashError:
            pass
        want["recovered"] = eval_recall(rc.WoWIndex.recover(root), wl)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for key, value in want.items():
        assert out[key] == value, key
    assert out["deleted_in_results"] == 0 and out["bitwise"]
    assert out["after_delete"] < 1.0  # the comparison is not vacuous
