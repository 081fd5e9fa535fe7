"""The port's replication (``repro_torch.persist.replicate``) against the
conformance cases of ``tests/test_replication.py``, on the CPU at the
reference's small workload (n <= 640, the ``KW`` parameters, numpy
builds), and against the JAX package itself:

* WAL shipping is bitwise, a quorum ack waits for the replica's fsync,
  and every deterministic fault schedule (drop / duplicate / reorder /
  partition) converges bitwise;
* a bootstrap streams the checkpoint in chunks, resumes after a replica
  crash by re-shipping only the missing chunks, and heals a dropped one;
* promotion raises the epoch on disk, fences the old primary, equals the
  old primary's disk at the promotion LSN, and a deposed primary with a
  diverged suffix re-bootstraps;
* across the packages: the frames are byte-equal for every message kind,
  both packages deliver the same messages of each kind under each fault
  schedule and end on the same digest, a primary of either package feeds
  a replica of the other over localhost TCP, and a port replica promoted
  at LSN L equals the JAX primary's disk recovered at L.

The ``cuda`` case ships device-build records to a replica on the card.
"""
import os
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import make_workload
from repro_torch.persist import (
    FaultSchedule,
    FaultTransport,
    InProcEndpoint,
    InProcTransport,
    PrimaryReplicator,
    QuorumTimeoutError,
    ReplicaReplicator,
    StaleEpochError,
    open_durable,
    recover,
    state_digest,
    wal_dir,
)
from repro_torch.persist import replicate as rep_mod
from repro_torch.persist import wal as walmod
from repro_torch.persist.checkpoint import list_checkpoints
from repro_torch.persist.checkpoint import save as save_ckpt
from repro_torch.persist.format import read_manifest
from repro_torch.persist.replicate import (
    MSG_CKPT_CHUNK,
    MSG_CKPT_META,
    decode_msg,
)

KW = dict(m=8, ef_construction=32, o=4, seed=0)
CPU = "cpu"
MSG_KINDS = sorted(v for k, v in vars(rep_mod).items()
                   if k.startswith("MSG_"))


@pytest.fixture(scope="module")
def wl():
    return make_workload(n=400, d=12, nq=1, seed=0, with_gt=False)


def counting_transport(inner=InProcTransport):
    """An ``inner`` transport (either package's ``InProcTransport``) that
    tallies the kinds of the messages it delivers (wrap it in the
    ``FaultTransport`` so only what was delivered is counted)."""

    class KindCounting(inner):
        def __init__(self):
            super().__init__()
            self.kinds = Counter()

        def send(self, src, dst, data):
            self.kinds[decode_msg(data)[0]] += 1
            return super().send(src, dst, data)

    return KindCounting()


def make_clock():
    T = [0.0]

    def now():
        return T[0]

    return T, now


def make_primary(root, transport, now, dim=12, node="P", quorum=1, **kw):
    ep = InProcEndpoint(transport, node)
    idx = open_durable(str(root), create=dict(dim=dim, **KW), device=CPU)
    prim = PrimaryReplicator(idx, str(root), ep, node_id=node, quorum=quorum,
                             now=now, **kw)
    prim.attach()
    return idx, prim


def make_replica(root, transport, now, node="R", primary="P", **kw):
    ep = InProcEndpoint(transport, node)
    rep = ReplicaReplicator(str(root), ep, node, primary_id=primary, now=now,
                            device=CPU, **kw)
    rep.start()
    return rep


def pump_until(T, prim, rep, cond, steps=4000, dt=0.02):
    for _ in range(steps):
        T[0] += dt
        prim.pump(T[0])
        rep.pump(T[0])
        if cond():
            return
    raise AssertionError(
        f"did not converge in {steps} pumps: primary lsn "
        f"{prim._last_lsn}, replica {rep.status()}")


# --------------------------------------------------------- basic shipping
def test_wal_shipping_replicates_bitwise(tmp_path, wl):
    T, now = make_clock()
    t = InProcTransport()
    idx, prim = make_primary(tmp_path / "p", t, now)
    rep = make_replica(tmp_path / "r", t, now)
    for i in range(4):
        idx.insert_batch(wl.vectors[50 * i:50 * (i + 1)],
                         wl.attrs[50 * i:50 * (i + 1)],
                         batch_size=25, backend="numpy")
        pump_until(T, prim, rep, lambda: rep.caught_up())
    assert rep.durable_lsn == prim._last_lsn
    assert rep.index._applied_lsn == idx._applied_lsn
    assert state_digest(rep.index) == state_digest(idx)
    p_recs = walmod.read_log(wal_dir(str(tmp_path / "p")))
    r_recs = walmod.read_log(wal_dir(str(tmp_path / "r")))
    assert [r for r in p_recs if r[0] > 0] == [r for r in r_recs if r[0] > 0]


def test_quorum_ack_waits_for_replica_fsync(tmp_path, wl):
    """quorum=2 with no live replica refuses the ack; with a replica the
    same append acks and the replica is durable at ack time."""
    T, now = make_clock()
    t = InProcTransport()
    idx, prim = make_primary(tmp_path / "p", t, now, quorum=2, max_pumps=64)
    with pytest.raises(QuorumTimeoutError):
        idx.insert_batch(wl.vectors[:10], wl.attrs[:10], batch_size=10,
                         backend="numpy")
    rep = make_replica(tmp_path / "r", t, now)
    prim.max_pumps = 200_000
    prim.peer_pump = lambda: rep.pump(T[0])
    idx.insert_batch(wl.vectors[10:20], wl.attrs[10:20], batch_size=10,
                     backend="numpy")
    assert rep.durable_lsn == prim._last_lsn
    on_disk = walmod.read_log(wal_dir(str(tmp_path / "r")))
    assert on_disk and on_disk[-1][0] == prim._last_lsn


# ------------------------------------------------------ fault-matrix sweep
def _schedules(FS):
    """The reference test's five schedules, built with ``FS`` (either
    package's ``FaultSchedule``)."""
    return {
        "drop-appends": FS(drop=[("P", "R", s) for s in (6, 7, 9)]),
        "drop-acks": FS(drop=[("R", "P", s) for s in (2, 3, 5)]),
        "duplicate": FS(dup=[("P", "R", s) for s in (5, 8)]
                        + [("R", "P", 4)]),
        "reorder": FS(delay=[("P", "R", 5, 2), ("P", "R", 8, 3)]),
        "partition": FS(partitions=[("P", "R", 6, 11), ("R", "P", 6, 11)]),
    }


SCHEDULE_NAMES = sorted(_schedules(FaultSchedule))


def _fault_run(tmp_path, wl, ft, mk_primary, mk_replica):
    """The reference's fault-schedule scenario: 6 batches of 30 rows, 3
    pumps after each, heal, pump to convergence."""
    T, now = make_clock()
    idx, prim = mk_primary(tmp_path / "p", ft, now)
    rep = mk_replica(tmp_path / "r", ft, now)
    for i in range(6):
        idx.insert_batch(wl.vectors[30 * i:30 * (i + 1)],
                         wl.attrs[30 * i:30 * (i + 1)],
                         batch_size=15, backend="numpy")
        for _ in range(3):
            T[0] += 0.02
            prim.pump(T[0])
            rep.pump(T[0])
    ft.heal()
    pump_until(T, prim, rep, lambda: rep.caught_up()
               and rep.durable_lsn == prim._last_lsn)
    return idx, prim, rep


@pytest.mark.parametrize("name", SCHEDULE_NAMES)
def test_fault_schedule_converges_bitwise(tmp_path, wl, name):
    """Every deterministic fault schedule converges to the same LSN with
    bitwise-equal state."""
    ft = FaultTransport(InProcTransport(), _schedules(FaultSchedule)[name])
    idx, _, rep = _fault_run(tmp_path, wl, ft, make_primary, make_replica)
    assert ft.dropped or ft.duplicated or ft.delayed, \
        "schedule never fired — the sweep tested nothing"
    assert state_digest(rep.index) == state_digest(idx)


# ------------------------------------------------- bootstrap chunk streams
def _big_primary(tmp_path, transport, now, quorum=1):
    """A primary whose vectors section spans several 256 KiB chunks."""
    wl = make_workload(n=640, d=128, nq=1, seed=3, with_gt=False)
    idx, prim = make_primary(tmp_path / "p", transport, now, dim=128,
                             quorum=quorum)
    idx.insert_batch(wl.vectors, wl.attrs, batch_size=128, backend="numpy")
    save_ckpt(idx, str(tmp_path / "p"), incremental=False)
    return idx, prim


def _total_chunks(root):
    man = read_manifest(list_checkpoints(str(root))[-1][1])
    return sum(len(e["chunk_crcs"]) for e in man["sections"].values())


def test_bootstrap_streams_chunked_checkpoint(tmp_path):
    T, now = make_clock()
    t = counting_transport()
    idx, prim = _big_primary(tmp_path, t, now)
    rep = make_replica(tmp_path / "r", t, now)
    pump_until(T, prim, rep, lambda: rep.caught_up())
    assert state_digest(rep.index) == state_digest(idx)
    total = _total_chunks(tmp_path / "p")
    assert total > len(read_manifest(
        list_checkpoints(str(tmp_path / "p"))[-1][1])["sections"]), \
        "fixture too small: every section fit one chunk"
    assert t.kinds[MSG_CKPT_CHUNK] == total


def test_bootstrap_resumes_after_replica_crash(tmp_path):
    """A replica killed mid-bootstrap resumes from ``MANIFEST.part`` and a
    CRC rescan; the primary re-ships only the missing chunks."""
    T, now = make_clock()
    ft = FaultTransport(InProcTransport(),
                        FaultSchedule(partitions=[("P", "R", 5, 10 ** 9)]))
    idx, prim = _big_primary(tmp_path, ft, now)
    rep = make_replica(tmp_path / "r", ft, now)
    for _ in range(8):
        T[0] += 0.02
        prim.pump(T[0])
        rep.pump(T[0])
    assert rep.index is None and rep._boot is not None
    got_before = sum(len(v) for v in rep._boot["got"].values())
    assert got_before == 2
    ft.kill("R")

    total = _total_chunks(tmp_path / "p")
    t2 = counting_transport()
    prim.endpoint = InProcEndpoint(t2, "P")
    rep2 = make_replica(tmp_path / "r", t2, now)
    assert rep2._boot is not None, "MANIFEST.part was not resumed"
    pump_until(T, prim, rep2, lambda: rep2.caught_up())
    assert state_digest(rep2.index) == state_digest(idx)
    assert t2.kinds[MSG_CKPT_CHUNK] == total - got_before, \
        "resume re-shipped chunks the replica already had"


def test_bootstrap_heals_dropped_chunk(tmp_path):
    """A chunk lost on the wire is re-requested after DONE."""
    T, now = make_clock()
    counter = counting_transport()
    ft = FaultTransport(counter, FaultSchedule(drop=[("P", "R", 4)]))
    idx, prim = _big_primary(tmp_path, ft, now)
    rep = make_replica(tmp_path / "r", ft, now)
    pump_until(T, prim, rep, lambda: rep.caught_up())
    assert ft.dropped == 1
    assert state_digest(rep.index) == state_digest(idx)
    assert counter.kinds[MSG_CKPT_CHUNK] == _total_chunks(tmp_path / "p")


# -------------------------------------------------------------- fencing
def test_epoch_fences_old_primary(tmp_path, wl):
    T, now = make_clock()
    t = InProcTransport()
    idx, prim = make_primary(tmp_path / "p", t, now)
    rep = make_replica(tmp_path / "r", t, now)
    idx.insert_batch(wl.vectors[:40], wl.attrs[:40], batch_size=20,
                     backend="numpy")
    pump_until(T, prim, rep, lambda: rep.caught_up())

    assert rep.promote() == 1
    assert rep.index._epoch == 1
    assert walmod.log_epoch(wal_dir(str(tmp_path / "r"))) == 1
    with pytest.raises(StaleEpochError):
        for _ in range(50):
            idx.insert_batch(wl.vectors[40:50], wl.attrs[40:50],
                             batch_size=10, backend="numpy")
            T[0] += 0.02
            prim.pump(T[0])
            rep.pump(T[0])
    assert prim.fenced
    assert rep.durable_lsn == 2


def test_promoted_replica_bitwise_equals_primary_at_promotion_lsn(
        tmp_path, wl):
    """The fenced primary's disk recovered at the promotion LSN equals the
    promoted replica, though its log runs past it."""
    T, now = make_clock()
    t = InProcTransport()
    idx, prim = make_primary(tmp_path / "p", t, now)
    rep = make_replica(tmp_path / "r", t, now)
    idx.insert_batch(wl.vectors[:60], wl.attrs[:60], batch_size=20,
                     backend="numpy")
    pump_until(T, prim, rep, lambda: rep.caught_up())
    promo_lsn = rep.durable_lsn

    t.kill("R")
    idx.insert_batch(wl.vectors[60:100], wl.attrs[60:100], batch_size=20,
                     backend="numpy")
    assert prim._last_lsn > promo_lsn

    rep.promote()
    fenced_at_promo = recover(str(tmp_path / "p"), upto_lsn=promo_lsn,
                              device=CPU)
    assert state_digest(fenced_at_promo) == state_digest(rep.index)
    full = recover(str(tmp_path / "p"), device=CPU)
    assert full._applied_lsn == prim._last_lsn
    assert state_digest(full) != state_digest(rep.index)


def test_deposed_primary_rejoin_rebootstraps_diverged_log(tmp_path, wl):
    """A deposed primary with an unacked suffix rejoins as a replica, is
    re-bootstrapped and converges bitwise; its diverged records are gone
    from its disk."""
    T, now = make_clock()
    t = InProcTransport()
    idx, prim = make_primary(tmp_path / "p", t, now)
    rep = make_replica(tmp_path / "r", t, now)
    idx.insert_batch(wl.vectors[:60], wl.attrs[:60], batch_size=20,
                     backend="numpy")
    pump_until(T, prim, rep, lambda: rep.caught_up())
    t.kill("R")
    idx.insert_batch(wl.vectors[60:80], wl.attrs[60:80], batch_size=20,
                     backend="numpy")
    idx._wal.close()

    t2 = counting_transport()
    rep.promote()
    new_idx = rep.index
    new_prim = PrimaryReplicator(new_idx, str(tmp_path / "r"),
                                 InProcEndpoint(t2, "R"), node_id="R",
                                 quorum=1, now=now)
    new_prim.attach()
    new_idx.insert_batch(wl.vectors[100:140], wl.attrs[100:140],
                         batch_size=20, backend="numpy")

    back = make_replica(tmp_path / "p", t2, now, node="P", primary="R")
    assert back.index is not None
    pump_until(T, new_prim, back, lambda: back.caught_up()
               and back.durable_lsn == new_prim._last_lsn)
    assert t2.kinds[MSG_CKPT_META] >= 1, "divergence was not re-bootstrapped"
    assert state_digest(back.index) == state_digest(new_idx)
    assert back.epoch == new_prim.epoch
    rec = recover(str(tmp_path / "p"), device=CPU)
    assert state_digest(rec) == state_digest(new_idx)


def test_replica_device_none_is_the_card(tmp_path):
    """``device=None`` is the card: without CUDA the replica raises, it
    never carries on on the CPU."""
    ep = InProcEndpoint(InProcTransport(), "R")
    if torch.cuda.is_available():
        rep = ReplicaReplicator(str(tmp_path), ep, "R")
        assert rep.device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ReplicaReplicator(str(tmp_path), ep, "R")


# ----------------------------------------------- across the two packages
def _jax():
    """The JAX package's replication, imported only here."""
    from repro import persist as jp
    from repro.persist import replicate as jr

    return jp, jr


@pytest.mark.parametrize("kind", MSG_KINDS)
def test_frames_byte_equal_across_packages(kind):
    """``encode_msg`` is byte-equal for the same (kind, head, payload), and
    each package decodes the other's frame."""
    _, jr = _jax()
    assert getattr(jr, [k for k, v in vars(rep_mod).items()
                        if k.startswith("MSG_") and v == kind][0]) == kind
    head = {"epoch": 3, "lsn": 17, "node": "R", "have": {"vectors": [0, 2]},
            "crc": 4_000_000_000, "f": 0.25}
    payload = np.arange(300, dtype=np.float32).tobytes()
    for p in (b"", payload):
        ours = rep_mod.encode_msg(kind, head, p)
        theirs = jr.encode_msg(kind, head, p)
        assert ours == theirs
        assert rep_mod.decode_msg(theirs) == jr.decode_msg(ours) == \
            (kind, head, p)
    assert rep_mod.BOOT_PART_NAME == jr.BOOT_PART_NAME


@pytest.mark.parametrize("name", SCHEDULE_NAMES)
def test_fault_schedule_counts_equal_across_packages(tmp_path, wl, name):
    """Under each schedule a JAX primary -> JAX replica run and a port
    primary -> port replica run deliver the same messages of each kind
    and end on the same digest."""
    jp, _ = _jax()

    def j_primary(root, transport, now):
        ep = jp.InProcEndpoint(transport, "P")
        idx = jp.open_durable(str(root), create=dict(dim=12, **KW))
        prim = jp.PrimaryReplicator(idx, str(root), ep, node_id="P",
                                    now=now)
        prim.attach()
        return idx, prim

    def j_replica(root, transport, now):
        rep = jp.ReplicaReplicator(str(root), jp.InProcEndpoint(
            transport, "R"), "R", primary_id="P", now=now)
        rep.start()
        return rep

    runs = {}
    for pkg, FT, FS, Inner, mk_p, mk_r, digest in (
            ("jax", jp.FaultTransport, jp.FaultSchedule, jp.InProcTransport,
             j_primary, j_replica, jp.state_digest),
            ("torch", FaultTransport, FaultSchedule, InProcTransport,
             make_primary, make_replica, state_digest)):
        counter = counting_transport(Inner)
        ft = FT(counter, _schedules(FS)[name])
        idx, prim, rep = _fault_run(tmp_path / pkg, wl, ft, mk_p, mk_r)
        runs[pkg] = (dict(counter.kinds), (ft.dropped, ft.duplicated,
                                           ft.delayed),
                     prim._last_lsn, digest(idx), digest(rep.index))
    assert runs["jax"] == runs["torch"]
    assert runs["torch"][3] == runs["torch"][4]


def _socket_pair(tmp_path, wl, prim_pkg, rep_pkg):
    """A primary of ``prim_pkg`` feeds a replica of ``rep_pkg`` over
    localhost TCP: 200 rows and a full checkpoint before the replica
    connects (a streamed bootstrap), then 3 shipped batches.  Returns the
    primary's index, the replica and the primary."""
    import time as wallclock

    proot, rroot = str(tmp_path / "p"), str(tmp_path / "r")
    rep_ep = rep_pkg.SocketEndpoint("R")
    kw = {} if rep_pkg is not rep_mod else {"device": CPU}
    rep = rep_pkg.ReplicaReplicator(rroot, rep_ep, "R", **kw)
    rep.start()
    prim_persist = prim_pkg["persist"]
    okw = {} if prim_pkg["name"] == "jax" else {"device": CPU}
    idx = prim_persist.open_durable(proot, create=dict(dim=12, **KW), **okw)
    idx.insert_batch(wl.vectors[:200], wl.attrs[:200], batch_size=50,
                     backend="numpy")
    prim_persist.save(idx, proot, incremental=False)
    p_ep = prim_persist.SocketEndpoint("P")
    p_ep.connect("R", rep_ep.addr)
    prim = prim_persist.PrimaryReplicator(idx, proot, p_ep, node_id="P",
                                          quorum=1)
    prim.attach()

    def pump(cond, steps=20_000):
        for _ in range(steps):
            rep.pump()
            prim.pump()
            if cond():
                return
            wallclock.sleep(0.0005)
        raise AssertionError(f"no convergence: {rep.status()}")

    pump(lambda: rep.caught_up())
    for i in range(3):
        lo = 200 + 40 * i
        idx.insert_batch(wl.vectors[lo:lo + 40], wl.attrs[lo:lo + 40],
                         batch_size=40, backend="numpy")
        pump(lambda: rep.caught_up() and rep.durable_lsn == prim._last_lsn)
    return idx, rep, prim, (p_ep, rep_ep)


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_socket_interop_across_packages(tmp_path, wl, direction):
    """A primary of either package bootstraps and feeds a replica of the
    other over localhost ``SocketEndpoint``s: equal ``state_digest`` on
    both sides, byte-equal logs."""
    jp, jr = _jax()
    import repro_torch.persist as tp

    pkgs = {"jax": {"name": "jax", "persist": jp},
            "torch": {"name": "torch", "persist": tp}}
    prim_name, rep_name = direction.split("-to-")
    rep_pkg = jr if rep_name == "jax" else rep_mod
    idx, rep, prim, eps = _socket_pair(tmp_path, wl, pkgs[prim_name],
                                       rep_pkg)
    try:
        # 4 records before the checkpoint (streamed), 3 shipped after it
        assert rep.index is not None and rep.durable_lsn == 7
        assert jp.state_digest(idx if prim_name == "jax" else rep.index) \
            == state_digest(rep.index if prim_name == "jax" else idx)
        p_recs = walmod.read_log(wal_dir(str(tmp_path / "p")))
        r_recs = walmod.read_log(wal_dir(str(tmp_path / "r")))
        assert [r[0] for r in r_recs] == [5, 6, 7]
        assert [r for r in p_recs if r[0] > 4] == r_recs
    finally:
        for ep in eps:
            ep.close()


def test_port_replica_promoted_equals_jax_primary_disk(tmp_path, wl):
    """A port replica fed by a JAX primary, promoted at LSN L, equals
    ``repro.persist.recover(primary_root, upto_lsn=L)`` of the JAX
    primary's disk, whose log runs past L."""
    jp, _ = _jax()
    T, now = make_clock()
    t = InProcTransport()
    proot = str(tmp_path / "p")
    jidx = jp.open_durable(proot, create=dict(dim=12, **KW))
    prim = jp.PrimaryReplicator(jidx, proot, jp.InProcEndpoint(t, "P"),
                                node_id="P", now=now)
    prim.attach()
    rep = make_replica(tmp_path / "r", t, now)
    jidx.insert_batch(wl.vectors[:90], wl.attrs[:90], batch_size=30,
                      backend="numpy")
    pump_until(T, prim, rep, lambda: rep.caught_up())
    promo_lsn = rep.durable_lsn
    assert promo_lsn == 3
    t.kill("R")
    jidx.insert_batch(wl.vectors[90:150], wl.attrs[90:150], batch_size=30,
                      backend="numpy")
    assert prim._last_lsn == 5
    assert rep.promote() == 1
    assert walmod.log_epoch(wal_dir(str(tmp_path / "r"))) == 1
    at_promo = jp.recover(proot, upto_lsn=promo_lsn)
    assert jp.state_digest(at_promo) == state_digest(rep.index)
    assert jp.state_digest(jp.recover(proot)) != state_digest(rep.index)


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason (decided per test, never at
    import: every worker must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc: the CUDA kernel cannot be built here")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replica_applies_device_records_bitwise(cuda_device, tmp_path,
                                                      wl):
    """On the card: a replica (``device=None``) bootstraps a primary's
    checkpoint, applies shipped device-build records through the kernel,
    and equals the primary bit for bit; promoted, it equals the
    primary's disk at the promotion LSN."""
    from repro_torch.kernels import launch_counters

    T, now = make_clock()
    t = InProcTransport()
    proot = str(tmp_path / "p")
    idx = open_durable(proot, create=dict(dim=12, **KW), device="cuda")
    idx.insert_batch(wl.vectors[:200], wl.attrs[:200], batch_size=100,
                     backend="device")
    save_ckpt(idx, proot, incremental=False)
    prim = PrimaryReplicator(idx, proot, InProcEndpoint(t, "P"),
                             node_id="P", quorum=2, now=now)
    prim.attach()
    rep = ReplicaReplicator(str(tmp_path / "r"), InProcEndpoint(t, "R"),
                            "R", primary_id="P", now=now)
    rep.start()
    assert rep.device.type == "cuda"
    prim.peer_pump = lambda: rep.pump(T[0])
    counts = {k: v for c in launch_counters() for k, v in c.items()}
    for i in range(2):
        lo = 200 + 64 * i
        idx.insert_batch(wl.vectors[lo:lo + 64], wl.attrs[lo:lo + 64],
                         batch_size=64, backend="device")
    launched = {k: v - counts[k] for c in launch_counters()
                for k, v in c.items()}
    assert launched["gather_norm_dot"] > 0
    assert rep.durable_lsn == prim._last_lsn == 4
    assert rep.index.device == torch.device("cuda")
    assert state_digest(rep.index) == state_digest(idx)
    t.kill("R")
    prim.quorum = 1
    idx.insert_batch(wl.vectors[328:360], wl.attrs[328:360], batch_size=32,
                     backend="device")
    assert prim._last_lsn == 5
    assert rep.promote() == 1
    assert state_digest(recover(proot, upto_lsn=4)) == \
        state_digest(rep.index)
