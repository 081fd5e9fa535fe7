"""The port's checkpoints and write-ahead log (``repro_torch.persist``)
against the JAX package's (``repro.persist``), on the CPU at the
reference's small workload (d 12, the ``KW`` parameters).

  * a checkpoint saved by either package loads in the other with the
    saving index's ``state_digest`` and passes ``assert_index_equal``, for
    the build backends sequential/numpy/ops/device and the slab types
    f32/int8/bf16, full and as a delta chain;
  * for one mutation sequence the two packages' WAL segments are byte for
    byte the same;
  * a log the JAX package wrote (batched, sequential, ``device``,
    ``"sharded"`` and ``device_width`` inserts, delete, undelete, compact)
    replays in the port to the JAX index's digest, and a log the port
    wrote (with ``device`` inserts) replays in the JAX package to the
    port's.

Whole device and ops builds of the two packages are not held bitwise (one
ulp of a distance can flip a neighbor choice, ``test_torch_device_build``);
each comparison here is between the index that saved or logged and the one
that loaded or replayed.  The JAX device builds compile their jits once
per shape, so every device build here uses the same micro-batch shapes.
"""
import os

import numpy as np
import pytest

import repro.core as rc
import repro.persist as rp
from repro.persist.checkpoint import load_state as ref_load_state
from repro_torch import core as tc
from repro_torch import persist as tp
from repro_torch.persist import wal as twal
from repro_torch.persist.format import read_manifest

KW = dict(m=8, ef_construction=32, o=4, seed=0)
CPU = "cpu"


@pytest.fixture(scope="module")
def wl():
    return rc.make_workload(n=400, d=12, nq=1, seed=0, with_gt=False)


def _pair(vec_dtype="f32"):
    return (rc.WoWIndex(dim=12, vec_dtype=vec_dtype, **KW),
            tc.WoWIndex(dim=12, vec_dtype=vec_dtype, device=CPU, **KW))


def _cross_load(tmp_path, tag, ri, ti):
    """Each package loads the other's newest checkpoint chain and must
    reproduce the saving index; returns the two manifests' kinds."""
    jroot, troot = str(tmp_path / f"jax-{tag}"), str(tmp_path / f"port-{tag}")
    rp.save(ri, jroot)
    tp.save(ti, troot)
    got_t = tp.load(jroot, device=CPU)
    assert tp.state_digest(got_t) == rp.state_digest(ri)
    tp.assert_index_equal(got_t, ri)
    assert got_t.vec_dtype == ri.vec_dtype
    got_j = rp.load(troot)
    assert rp.state_digest(got_j) == tp.state_digest(ti)
    rp.assert_index_equal(got_j, ti)
    return [read_manifest(tp.list_checkpoints(r)[-1][1])["kind"]
            for r in (jroot, troot)]


@pytest.mark.parametrize("backend,vec_dtype", [
    ("sequential", "f32"), ("numpy", "f32"), ("numpy", "int8"),
    ("numpy", "bf16"), ("ops", "f32"), ("device", "f32"),
    ("device", "int8"), ("device", "bf16"),
])
def test_checkpoint_cross_loads(tmp_path, wl, backend, vec_dtype):
    """Full checkpoints, then a delta chain after more inserts and a
    delete, load across the packages bitwise."""
    ri, ti = _pair(vec_dtype)
    for idx in (ri, ti):
        if backend == "sequential":
            for v, a in zip(wl.vectors[:120], wl.attrs[:120]):
                idx.insert(v, a)
        else:
            idx.insert_batch(wl.vectors[:160], wl.attrs[:160],
                             batch_size=80, backend=backend)
        idx.delete(3)
        idx.delete(17)
        idx.undelete(3)
    assert _cross_load(tmp_path, "a", ri, ti) == ["full", "full"]
    for idx in (ri, ti):
        idx.insert_batch(wl.vectors[200:240], wl.attrs[200:240] + 0.5,
                         batch_size=40)
        idx.delete(5)
    assert _cross_load(tmp_path, "a", ri, ti) == ["delta", "delta"]


def _sequence(idx, wl, root):
    """One mutation sequence on a durable index (either package): batched
    and sequential inserts, delete/undelete, a manual and an automatic
    compaction, a checkpoint (log rotation) in between."""
    idx.insert_batch(wl.vectors[:100], wl.attrs[:100], batch_size=50)
    idx.insert(wl.vectors[100], float(wl.attrs[100]))
    for vid in (7, 8, 31):
        idx.delete(vid)
    idx.undelete(8)
    idx.compact_rows()
    idx.checkpoint(root)
    for vid in range(40, 70):
        idx.delete(vid)
    idx.insert_batch(wl.vectors[101:141], wl.attrs[101:141], batch_size=40)
    assert idx.compactions == 1
    idx._wal.close()


def test_wal_segments_byte_equal(tmp_path, wl):
    """The same mutation sequence writes byte-equal WAL segments and
    checkpoints of equal digest in both packages."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    create = dict(dim=12, compact_threshold=0.2, **KW)
    ri = rp.open_durable(jroot, create=create)
    ti = tp.open_durable(troot, create=create, device=CPU)
    _sequence(ri, wl, jroot)
    _sequence(ti, wl, troot)
    assert tp.state_digest(ti) == rp.state_digest(ri)
    jsegs = twal.list_segments(tp.wal_dir(jroot))
    tsegs = twal.list_segments(tp.wal_dir(troot))
    assert [s for s, _ in jsegs] == [s for s, _ in tsegs] and len(jsegs) == 2
    for (_, a), (_, b) in zip(jsegs, tsegs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
    kinds = [t for _, t, _ in twal.read_log(tp.wal_dir(troot))]
    assert twal.T_COMPACT in kinds and twal.T_INSERT in kinds
    # either package recovers either directory to the same state
    for root in (jroot, troot):
        assert tp.state_digest(tp.recover(root, device=CPU)) == \
            rp.state_digest(rp.recover(root)) == rp.state_digest(ri)


def test_jax_log_replays_in_port(tmp_path, wl):
    """A JAX-written log of every record kind, including the device build,
    a ``"sharded"`` record (replayed on the device build) and a
    ``device_width`` record, replays in the port to the JAX digest."""
    root = str(tmp_path)
    ri = rp.open_durable(root, create=dict(dim=12, **KW))
    ri.insert_batch(wl.vectors[:160], wl.attrs[:160], batch_size=80)
    ri.insert_batch(wl.vectors[160:240], wl.attrs[160:240], batch_size=80,
                    backend="device")
    ri.insert_batch(wl.vectors[240:280], wl.attrs[240:280], batch_size=40,
                    backend="sharded", shards=1)
    ri.insert_batch(wl.vectors[280:320], wl.attrs[280:320], batch_size=40,
                    backend="device", device_width=16)
    ri.insert(wl.vectors[320], float(wl.attrs[320]))
    ri.delete(5)
    ri.delete(9)
    ri.undelete(5)
    ri.compact_rows()
    ri._wal.close()
    heads = [twal.unpack_insert(p)[2] for _, t, p in
             twal.read_log(tp.wal_dir(root)) if t == twal.T_INSERT]
    assert [h["backend"] for h in heads] == [
        "numpy", "numpy", "device", "sharded", "device"]
    assert heads[-1]["device_width"] == 16 and heads[3]["shards"] == 1
    ti = tp.recover(root, device=CPU)
    assert ti._applied_lsn == ri._applied_lsn
    assert tp.state_digest(ti) == rp.state_digest(ri)
    tp.assert_index_equal(ti, ri)


def test_port_log_replays_in_jax(tmp_path, wl):
    """A port-written log with device-build records replays in the JAX
    package to the port's digest, after a JAX-loadable checkpoint."""
    root = str(tmp_path)
    ti = tp.open_durable(root, create=dict(dim=12, **KW), device=CPU)
    ti.insert_batch(wl.vectors[:160], wl.attrs[:160], batch_size=80)
    ti.checkpoint(root)
    ti.insert_batch(wl.vectors[160:240], wl.attrs[160:240], batch_size=80,
                    backend="device")
    ti.insert_batch(wl.vectors[280:320], wl.attrs[280:320], batch_size=40,
                    backend="device", device_width=16)
    ti.delete(11)
    ti.compact_rows()
    ti._wal.close()
    assert ref_load_state(root)["meta"]["lsn"] == 2
    ri = rp.recover(root)
    assert ri._applied_lsn == ti._applied_lsn == 6
    assert rp.state_digest(ri) == tp.state_digest(ti)
    rp.assert_index_equal(ri, ti)
