"""The port's durable index lifecycle (``repro_torch.persist``) against the
conformance cases of ``tests/test_persistence.py``, on the CPU at the
reference's small workload (n <= 400, d 12, the ``KW`` parameters).

A checkpoint round trip is bitwise (slabs, graph arenas, WBT shape, RNG
stream); recovery after a crash at any byte offset or io operation lands
on exactly the last durable prefix state, never a corrupt index and never
a silently shortened log with valid data beyond the damage; ingest
validation rejects bad input before a byte of index or log changes.
Faults come from ``repro_torch.persist.faultfs`` (torn writes, bit flips,
dropped fsyncs, op-sweep crashes) and a real SIGKILL of a subprocess that
runs the port with ``device="cpu"``.  Every build here is the host
(numpy) one; the device-build records are held against the JAX package in
``test_torch_persist.py``.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest

from repro_torch.core import WoWIndex, make_workload
from repro_torch.core.snapshot import take_snapshot
from repro_torch.persist import (
    CorruptError,
    CrashError,
    FaultIO,
    WalCorruptError,
    assert_index_equal,
    flip_bit,
    list_checkpoints,
    load,
    load_serving_snapshot,
    open_durable,
    recover,
    save,
    state_digest,
    truncate_at,
    wal_dir,
)
from repro_torch.persist import format as fmt
from repro_torch.persist import wal as walmod
from repro_torch.persist.checkpoint import load_state, materialize
from repro_torch.persist.format import read_manifest

KW = dict(m=8, ef_construction=32, o=4, seed=0)
CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def wl():
    return make_workload(n=400, d=12, nq=1, seed=0, with_gt=False)


def _build(wl, bs=64, n=None, **kw):
    idx = WoWIndex(dim=12, device=CPU, **{**KW, **kw})
    n = len(wl.attrs) if n is None else n
    if bs is None:
        for v, a in zip(wl.vectors[:n], wl.attrs[:n]):
            idx.insert(v, a)
    else:
        idx.insert_batch(wl.vectors[:n], wl.attrs[:n], batch_size=bs)
    return idx


def _durable(root, **kw):
    return open_durable(root, create=dict(dim=12, **KW, **kw), device=CPU)


def _mutate(idx, wl, lo, hi, bs=50):
    idx.insert_batch(wl.vectors[lo:hi], wl.attrs[lo:hi], batch_size=bs)


# ------------------------------------------------------- checkpoint round trip
@pytest.mark.parametrize("bs", [None, 96])
def test_roundtrip(tmp_path, wl, bs):
    """save -> load is bitwise (slabs, graph arenas, WBT, tombstones, RNG
    state, mutation stamps), sequential and batched builds."""
    idx = _build(wl, bs=bs, n=200 if bs is None else None)
    idx.delete(3)
    idx.delete(17)
    idx.undelete(3)
    save(idx, str(tmp_path))
    assert_index_equal(idx, load(str(tmp_path), device=CPU))


def test_roundtrip_preserves_rng_stream(tmp_path, wl):
    """The loaded index continues the exact RNG stream."""
    idx = _build(wl)
    idx.delete(5)
    save(idx, str(tmp_path))
    twin = load(str(tmp_path), device=CPU)
    for target in (idx, twin):
        target.insert_batch(wl.vectors[:60] + 0.25, wl.attrs[:60] + 1000.0,
                            batch_size=30)
        target.delete(int(target.store.n) - 1)
    assert state_digest(idx) == state_digest(twin)
    assert_index_equal(idx, twin)


def test_incremental_checkpoint_is_delta_and_bitwise(tmp_path, wl):
    """Steady-state checkpoints are deltas and compose back exactly."""
    root, root_full = str(tmp_path / "inc"), str(tmp_path / "full")
    idx = _build(wl)
    save(idx, root)
    seq0, path0 = list_checkpoints(root)[-1]
    assert read_manifest(path0)["kind"] == "full"
    _mutate(idx, wl, 0, 80)
    idx.delete(9)
    idx.compact_rows()
    save(idx, root, incremental=True)
    save(idx, root_full, incremental=False)
    man = read_manifest(list_checkpoints(root)[-1][1])
    assert man["kind"] == "delta" and man["base"] == seq0
    full_nbytes = sum(e["nbytes"] for e in
                      read_manifest(path0)["sections"].values())
    assert sum(e["nbytes"] for e in man["sections"].values()) < full_nbytes
    a, b = load(root, device=CPU), load(root_full, device=CPU)
    assert state_digest(a) == state_digest(b) == state_digest(idx)
    assert_index_equal(idx, a)


def test_checkpoint_retention_keeps_chains_recoverable(tmp_path, wl):
    """Two checkpoints are kept, the log is pruned past them, and the
    newest chain recovers."""
    root = str(tmp_path)
    idx = _durable(root)
    for i in range(5):
        _mutate(idx, wl, 40 * i, 40 * (i + 1), bs=40)
        idx.checkpoint(root, incremental=False)
    idx._wal.close()
    assert len(list_checkpoints(root)) == 2
    assert len(walmod.list_segments(wal_dir(root))) == 2
    assert_index_equal(idx, recover(root, device=CPU))


# ------------------------------------------------------------------ WAL replay
def test_wal_replay_parity_mixed_trace(tmp_path, wl):
    """checkpoint + WAL suffix reproduces a mixed trace bitwise (batched
    and sequential inserts, delete/undelete, compaction), and a reopened
    writer continues at the right LSN."""
    root = str(tmp_path)
    idx = _durable(root)
    _mutate(idx, wl, 0, 100)
    idx.checkpoint(root)
    _mutate(idx, wl, 100, 200, bs=64)
    idx.insert(wl.vectors[200], float(wl.attrs[200]))
    idx.delete(7)
    idx.delete(31)
    idx.undelete(7)
    idx.compact_rows()
    _mutate(idx, wl, 201, 260, bs=30)
    idx._wal.close()
    idx._wal = None  # detach: idx keeps mutating below, un-logged
    rec = WoWIndex.recover(root, device=CPU)
    assert rec._applied_lsn == idx._applied_lsn
    assert_index_equal(idx, rec)
    re2 = open_durable(root, device=CPU)
    assert re2._wal.next_lsn == idx._applied_lsn + 1
    for target in (idx, re2):
        target.insert_batch(wl.vectors[260:300], wl.attrs[260:300],
                            batch_size=40)
    assert state_digest(idx) == state_digest(re2)
    re2._wal.close()


# ----------------------------------------------------- torn tails & bit flips
@pytest.fixture(scope="module")
def trace(tmp_path_factory, wl):
    """A durable dir with an empty initial checkpoint + a short mixed WAL,
    and ``digests[k]``: the exact state after the first k records."""
    root = str(tmp_path_factory.mktemp("trace"))
    idx = _durable(root)
    for i in range(3):
        _mutate(idx, wl, 30 * i, 30 * (i + 1), bs=30)
    idx.delete(2)
    idx.insert(wl.vectors[90], float(wl.attrs[90]))
    idx.undelete(2)
    idx.compact_rows()
    _mutate(idx, wl, 91, 121, bs=30)
    idx._wal.close()
    base = materialize(load_state(root), device=CPU)
    digests = [state_digest(base)]
    base._wal_replaying = True
    for lsn, rtype, payload in walmod.read_log(wal_dir(root)):
        walmod.apply_record(base, rtype, payload)
        base._applied_lsn = lsn
        digests.append(state_digest(base))
    assert digests[-1] == state_digest(idx)
    (_, seg), = walmod.list_segments(wal_dir(root))
    return root, digests, os.path.basename(seg)


def _copy(root, work):
    shutil.copytree(root, work)
    return work


def test_torn_tail_sweep_recovers_exact_prefix(tmp_path, trace):
    """Kill the writer at any byte offset of the WAL: recovery truncates
    the torn tail and lands on exactly the longest durable prefix, and
    the truncated log accepts appends again."""
    root, digests, seg = trace
    scan = walmod.scan_segment(os.path.join(wal_dir(root), seg))
    ends = [end for _, _, _, end in scan["records"]]
    points = {0, 5, walmod.SEG_HEADER_LEN}
    for e in ends:
        points.update((e - 3, e))  # mid-record and clean boundary
    for t in sorted(points):
        work = _copy(root, str(tmp_path / f"torn-{t}"))
        truncate_at(os.path.join(wal_dir(work), seg), t)
        rec = recover(work, device=CPU)
        k = sum(1 for e in ends if e <= t)
        assert state_digest(rec) == digests[k], f"truncation at byte {t}"
        re2 = open_durable(work, device=CPU)
        assert re2._wal.next_lsn == rec._applied_lsn + 1
        re2._wal.close()


def test_bitflip_midlog_is_refused_not_shortened(tmp_path, trace):
    """A flipped bit with valid records after it is corruption, not a torn
    tail: recovery refuses."""
    root, _, seg = trace
    scan = walmod.scan_segment(os.path.join(wal_dir(root), seg))
    for byte in (walmod.SEG_HEADER_LEN + 9, scan["records"][0][3] - 2):
        work = _copy(root, str(tmp_path / f"flip-{byte}"))
        flip_bit(os.path.join(wal_dir(work), seg), byte, bit=3)
        with pytest.raises(WalCorruptError):
            recover(work, device=CPU)


def test_bitflip_in_final_record_truncates_to_prefix(tmp_path, trace):
    """A flip inside the last record is a torn tail: recovery truncates to
    the previous record."""
    root, digests, seg = trace
    scan = walmod.scan_segment(os.path.join(wal_dir(root), seg))
    work = _copy(root, str(tmp_path / "flip-final"))
    flip_bit(os.path.join(wal_dir(work), seg), scan["records"][-2][3] + 9,
             bit=1)
    assert state_digest(recover(work, device=CPU)) == digests[-2]


# ----------------------------------------------- checkpoint-save crash sweeps
@pytest.mark.parametrize("model", ["flushed", "lost"])
def test_checkpoint_save_crash_sweep(tmp_path, wl, model):
    """Kill the checkpoint writer at every io operation under both crash
    models: load() yields the previous checkpoint's state or the new one,
    nothing in between."""
    root = str(tmp_path / model)
    idx = _build(wl)
    save(idx, root)
    d_old = state_digest(idx)
    _mutate(idx, wl, 0, 60, bs=30)
    idx.delete(4)
    d_new = state_digest(idx)
    k = 0
    while True:
        k += 1
        io = FaultIO(crash_after_ops=k, model=model)
        try:
            save(idx, root, io=io, incremental=True)
            crashed = False
        except CrashError:
            crashed = True
        got = state_digest(load(root, device=CPU))
        assert got in (d_old, d_new), f"crash at op {k} [{model}]"
        if not crashed:
            assert got == d_new
            break
        assert k < 500, "sweep failed to terminate"


def test_dropped_fsyncs_lose_only_unsynced_records(tmp_path, wl):
    """drop_fsync + model="lost": appends whose fsync was dropped vanish
    at the crash; recovery lands on the last durable state."""
    root = str(tmp_path)
    idx = _durable(root)
    _mutate(idx, wl, 0, 60, bs=30)
    idx.checkpoint(root)
    idx._wal.close()
    d_durable = state_digest(idx)
    crashed = False
    for k in range(1, 200):
        work = _copy(root, str(tmp_path / f"drop-{k}"))
        io = FaultIO(crash_after_ops=k, drop_fsync=True, model="lost")
        try:
            idx2 = open_durable(work, io=io, device=CPU)
            _mutate(idx2, wl, 60, 120, bs=30)
            idx2._wal.close()
        except CrashError:
            crashed = True
            assert state_digest(recover(work, device=CPU)) == d_durable, k
            continue
        break
    assert crashed, "the sweep never hit an io operation"


def test_kill9_mid_ingest_recovers_acked_batches(tmp_path):
    """Real SIGKILL of a process running the port mid-ingest: every
    micro-batch acked before the kill is recovered, reproducing the index
    a clean run of those batches builds."""
    root = str(tmp_path)
    child = f"""
import os, signal
from repro_torch.core import make_workload
from repro_torch.persist import open_durable
wl = make_workload(n=300, d=12, nq=1, seed=7, with_gt=False)
idx = open_durable({root!r}, create=dict(dim=12, m=8, ef_construction=32,
                                         o=4, seed=0), device="cpu")
for i in range(6):
    idx.insert_batch(wl.vectors[50*i:50*(i+1)], wl.attrs[50*i:50*(i+1)],
                     batch_size=50)
    print("ACK", i, flush=True)
    if i == 3:
        os.kill(os.getpid(), signal.SIGKILL)
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == -signal.SIGKILL, res.stderr
    acked = res.stdout.count("ACK")
    assert acked == 4
    rec = recover(root, device=CPU)
    wl = make_workload(n=300, d=12, nq=1, seed=7, with_gt=False)
    want = WoWIndex(dim=12, device=CPU, **KW)
    for i in range(acked):
        want.insert_batch(wl.vectors[50 * i:50 * (i + 1)],
                          wl.attrs[50 * i:50 * (i + 1)], batch_size=50)
    assert state_digest(rec) == state_digest(want)
    assert_index_equal(rec, want)


# -------------------------------------------------- ingest validation gates
def test_ingest_validation_rejects_before_any_mutation(tmp_path, wl):
    """NaN/inf attrs, wrong-dim and non-finite vectors raise before any
    mutation: the digest and the WAL bytes are unchanged."""
    root = str(tmp_path)
    idx = _durable(root)
    _mutate(idx, wl, 0, 60, bs=30)
    (_, seg_path), = walmod.list_segments(wal_dir(root))
    d0 = state_digest(idx)
    with open(seg_path, "rb") as f:
        wal_bytes = f.read()
    bad_attr = wl.attrs[:4].copy()
    bad_attr[2] = np.nan
    with pytest.raises(ValueError, match="attr"):
        idx.insert_batch(wl.vectors[:4], bad_attr, batch_size=4)
    with pytest.raises(ValueError, match="dim"):
        idx.insert_batch(wl.vectors[:4, :7], wl.attrs[:4], batch_size=4)
    bad_vec = wl.vectors[:4].copy()
    bad_vec[1, 3] = np.inf
    with pytest.raises(ValueError, match="finite"):
        idx.insert_batch(bad_vec, wl.attrs[:4], batch_size=4)
    with pytest.raises(ValueError):
        idx.insert(wl.vectors[0], float("inf"))
    with pytest.raises(ValueError, match="device_width"):
        idx.insert_batch(wl.vectors[:4], wl.attrs[:4], device_width=8)
    assert state_digest(idx) == d0
    with open(seg_path, "rb") as f:
        assert f.read() == wal_bytes
    idx._wal.close()


# ------------------------------------------------------- background compaction
def test_auto_compaction_triggers_logs_and_recovers(tmp_path, wl):
    """The tombstone-fraction cadence fires at an insert_batch boundary,
    logs one COMPACT record, latches, and replays bitwise."""
    root = str(tmp_path)
    idx = _durable(root, compact_threshold=0.25)
    _mutate(idx, wl, 0, 100)
    for vid in range(30):
        idx.delete(vid)
    assert idx.compactions == 0
    _mutate(idx, wl, 100, 140, bs=40)
    assert idx.compactions == 1
    _mutate(idx, wl, 140, 180, bs=40)
    assert idx.compactions == 1
    types = [t for _, t, _ in walmod.read_log(wal_dir(root))]
    assert types.count(walmod.T_COMPACT) == 1
    idx._wal.close()
    assert_index_equal(idx, recover(root, device=CPU))


# --------------------------------------------------- serve-from-checkpoint
@pytest.mark.parametrize("vec_dtype", ["f32", "int8", "bf16"])
def test_cold_start_snapshot_matches_take_snapshot(tmp_path, wl, vec_dtype):
    """The mapped cold-start snapshot is bitwise ``take_snapshot`` of the
    live index, with and without tombstones; a quantized checkpoint's
    q-slab rides along (a bf16 slab as its uint16 bits) and equals the
    live slab's quantization."""
    from repro_torch.core.store import quantize_rows

    for name, dels in (("clean", ()), ("holes", (3, 11, 40))):
        root = str(tmp_path / name)
        idx = _build(wl, vec_dtype=vec_dtype)
        for vid in dels:
            idx.delete(vid)
        save(idx, root)
        snap, meta = load_serving_snapshot(root)
        want = take_snapshot(idx)
        assert meta["n"] == idx.store.n and meta["vec_dtype"] == vec_dtype
        if not dels:
            assert not snap.vectors.flags.writeable  # a read-only mapping
        for field in ("vectors", "sq_norms", "attrs", "neighbors", "uvals",
                      "uval_rep", "ids_map"):
            assert np.array_equal(getattr(snap, field),
                                  getattr(want, field)), (name, field)
        assert (snap.m, snap.o, snap.metric) == (want.m, want.o, want.metric)
        if vec_dtype == "f32":
            assert snap.q_vectors is None
            continue
        q, s = quantize_rows(want.vectors, vec_dtype)
        assert snap.q_vectors.dtype == (np.uint16 if vec_dtype == "bf16"
                                        else np.int8)
        np.testing.assert_array_equal(snap.q_vectors, q)
        if vec_dtype == "int8":
            np.testing.assert_array_equal(snap.q_scales, s)


@pytest.mark.parametrize("vec_dtype", ["f32", "int8", "bf16"])
def test_cold_start_snapshot_serves_queries(tmp_path, vec_dtype):
    """checkpoint -> load_serving_snapshot -> search_batch answers equal
    the live index's snapshot's, and the upload copies the read-only
    mapping instead of aliasing it (no non-writable-array warning)."""
    from repro_torch.core.device_search import search_batch

    wlq = make_workload(n=300, d=12, nq=8, seed=3, k=5)
    root = str(tmp_path)
    idx = _build(wlq, vec_dtype=vec_dtype)
    save(idx, root)
    snap, _ = load_serving_snapshot(root)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = search_batch(snap, wlq.queries, wlq.ranges, k=5, width=32,
                           vec_dtype=vec_dtype, device=CPU)
    # the live snapshot's f32 slab, quantized per row at the upload: the
    # checkpoint's q-slab bit for bit
    want = search_batch(take_snapshot(idx), wlq.queries, wlq.ranges, k=5,
                        width=32, vec_dtype=vec_dtype, device=CPU)
    for a, b in zip(res, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_roundtrip_full_and_delta(tmp_path, wl, mode):
    """A quantized index checkpoints its q-slab sections and both the full
    and the delta chain round-trip bitwise."""
    root = str(tmp_path)
    idx = _build(wl, vec_dtype=mode)
    save(idx, root)
    sec = read_manifest(list_checkpoints(root)[-1][1])["sections"]
    assert sec["q_vectors"]["dtype"] == ("int8" if mode == "int8"
                                         else "uint16")
    assert ("q_scales" in sec) == (mode == "int8")
    got = load(root, device=CPU)
    assert got.vec_dtype == mode
    assert_index_equal(idx, got)
    _mutate(idx, wl, 0, 80)
    save(idx, root, incremental=True)
    man = read_manifest(list_checkpoints(root)[-1][1])
    assert man["kind"] == "delta" and "q_vectors_tail" in man["sections"]
    assert state_digest(load(root, device=CPU)) == state_digest(idx)


def test_delta_base_mismatched_vec_dtype_forces_full(tmp_path, wl):
    root = str(tmp_path)
    idx = _build(wl)
    save(idx, root)
    idx.vec_dtype = "int8"
    _mutate(idx, wl, 0, 40, bs=40)
    save(idx, root, incremental=True)
    man = read_manifest(list_checkpoints(root)[-1][1])
    assert man["kind"] == "full" and man["meta"]["vec_dtype"] == "int8"
    assert state_digest(load(root, device=CPU)) == state_digest(idx)


# --------------------------------------- dead-value attribute pipeline (f32)
def _downgrade_to_v1(ckpt_path: str) -> None:
    """Rewrite a v2 checkpoint in place as its v1 equivalent."""
    man = read_manifest(ckpt_path)
    man.pop("header_crc32")
    for name in [s for s in man["sections"] if s.split("_tail")[0]
                 in ("dead_vals", "q_vectors", "q_scales")]:
        os.remove(os.path.join(ckpt_path, man["sections"][name]["file"]))
        del man["sections"][name]
    man["meta"].pop("vec_dtype", None)
    man["format_version"] = 1
    man["header_crc32"] = fmt.crc32(fmt.canonical_json(man))
    with open(os.path.join(ckpt_path, fmt.MANIFEST_NAME), "w") as f:
        f.write(json.dumps(man, sort_keys=True, indent=1))


def test_v1_checkpoint_reads_with_dead_vals_migration(tmp_path, wl):
    """A v1 checkpoint (no dead_vals section, no vec_dtype meta) reads,
    reconstructing the dead list from attrs and tombstones."""
    root = str(tmp_path)
    idx = _build(wl)
    val = float(idx.store.attrs[7])
    for vid in range(idx.store.n):
        if float(idx.store.attrs[vid]) == val:
            idx.delete(vid)
    assert val in idx._dead_vals
    save(idx, root)
    path = list_checkpoints(root)[-1][1]
    _downgrade_to_v1(path)
    assert read_manifest(path)["format_version"] == 1
    got = load(root, device=CPU)
    assert got.vec_dtype == "f32" and got._dead_vals == idx._dead_vals
    assert state_digest(got) == state_digest(idx)


def test_dead_vals_f32_roundtrip_no_resurrection(tmp_path):
    """A dead value that f64 and f32 represent differently (0.1) stays dead
    across a round trip (the dead list is stored f32, as attrs are)."""
    rng = np.random.default_rng(0)
    idx = WoWIndex(dim=8, device=CPU, **KW)
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    idx.insert_batch(vecs, np.arange(20.0), batch_size=20)
    tricky = 0.1
    assert float(np.float32(tricky)) != tricky
    idx.insert(rng.standard_normal(8).astype(np.float32), tricky)
    vid = idx.store.n - 1
    canon = float(np.float32(tricky))
    assert float(idx.store.attrs[vid]) == canon
    lo, hi = canon - 1e-6, canon + 1e-6
    assert idx.selectivity(lo, hi) == 1
    idx.delete(vid)
    assert idx.selectivity(lo, hi) == 0 and idx._dead_vals == [canon]
    root = str(tmp_path)
    save(idx, root)
    sec = read_manifest(list_checkpoints(root)[-1][1])["sections"]
    assert sec["dead_vals"]["dtype"] == "float32"
    got = load(root, device=CPU)
    assert got._dead_vals == [canon] and got.selectivity(lo, hi) == 0
    for target in (idx, got):
        target.insert(vecs[0], tricky)
    assert idx._dead_vals == got._dead_vals == []
    assert state_digest(idx) == state_digest(got)


# --------------------------------------------------------- refusal hygiene
def test_recover_refuses_empty_and_garbage_dirs(tmp_path):
    with pytest.raises(CorruptError):
        recover(str(tmp_path / "nothing"), device=CPU)
    ck = os.path.join(str(tmp_path / "garbage"), "checkpoints",
                      "ckpt-00000001")
    os.makedirs(ck)
    with open(os.path.join(ck, "MANIFEST.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(CorruptError):
        recover(str(tmp_path / "garbage"), device=CPU)
    with pytest.raises(ValueError, match="create="):
        open_durable(str(tmp_path / "fresh"), device=CPU)


def test_corrupt_newest_checkpoint_falls_back_to_older(tmp_path, wl):
    """A corrupt newest checkpoint falls back to the older one, and the WAL
    suffix re-applies the difference."""
    root = str(tmp_path)
    idx = _durable(root)
    _mutate(idx, wl, 0, 60, bs=30)
    idx.checkpoint(root)
    _mutate(idx, wl, 60, 120, bs=30)
    idx.checkpoint(root)
    idx._wal.close()
    path = list_checkpoints(root)[-1][1]
    man = read_manifest(path)
    assert man["kind"] == "delta"
    _, sec = max(man["sections"].items(), key=lambda kv: kv[1]["nbytes"])
    flip_bit(os.path.join(path, sec["file"]), sec["nbytes"] // 2)
    assert_index_equal(idx, recover(root, device=CPU))


# ------------------------------------------------------ WAL reopen hardening
def test_wal_reopen_after_prune_verifies_epoch_and_lsn_continuity(tmp_path):
    """A writer reopening a pruned, epoch-rotated log adopts the newest
    epoch and continues the LSNs; a lower explicit epoch is refused, a
    higher one is stamped before any append."""
    d = str(tmp_path / "wal")
    w = walmod.WalWriter(d, segment_bytes=128)
    for _ in range(6):
        w.append(walmod.T_COMPACT, b"x" * 40)
    w.set_epoch(2)
    for _ in range(4):
        w.append(walmod.T_COMPACT, b"y" * 40)
    assert len(walmod.list_segments(d)) > 2
    assert w.prune(keep_from_lsn=6) >= 1
    w.close()
    w2 = walmod.WalWriter(d, segment_bytes=128)
    assert w2.epoch == 2 and w2.next_lsn == 11
    assert w2.append(walmod.T_COMPACT, b"z") == 11
    w2.close()
    recs = walmod.read_log(d)
    assert [r[0] for r in recs] == list(range(recs[0][0], 12))
    with pytest.raises(walmod.StaleEpochError):
        walmod.WalWriter(d, segment_bytes=128, epoch=1)
    w3 = walmod.WalWriter(d, segment_bytes=128, epoch=5)
    assert walmod.log_epoch(d) == 5 and w3.next_lsn == 12
    w3.close()


def test_wal_reopen_with_torn_final_segment_header_selfheals(tmp_path):
    """A torn header of a record-less tail segment (a crash mid-rotate) is
    removed on reopen; the same tear in a non-final segment is refused."""
    d = str(tmp_path / "wal")
    w = walmod.WalWriter(d)
    for _ in range(5):
        w.append(walmod.T_COMPACT, b"p" * 8)
    w.set_epoch(1)
    w.close()
    segs = walmod.list_segments(d)
    assert len(segs) == 2
    truncate_at(segs[-1][1], walmod.SEG_HEADER_LEN // 3)
    w2 = walmod.WalWriter(d)
    assert walmod.list_segments(d) == segs[:-1]
    assert w2.next_lsn == 6 and w2.epoch == 0
    assert w2.append(walmod.T_COMPACT, b"q") == 6
    w2.close()
    assert [r[0] for r in walmod.read_log(d)] == [1, 2, 3, 4, 5, 6]
    w3 = walmod.WalWriter(d)
    w3.rotate()
    w3.append(walmod.T_COMPACT, b"r")
    w3.close()
    segs = walmod.list_segments(d)
    truncate_at(segs[0][1], walmod.SEG_HEADER_LEN // 3)
    with pytest.raises(WalCorruptError):
        walmod.WalWriter(d)
