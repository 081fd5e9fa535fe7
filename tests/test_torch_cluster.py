"""The port's replicated serving cluster (``repro_torch.serve.cluster``)
against the cluster cases of ``tests/test_replication.py``, on the CPU at
the reference's small workload (n 400, d 12, numpy builds):

* a killed primary with queries in flight fails over to the most durable
  replica (epoch 1), every query is answered and no acked write is lost;
* a rolling restart (replicas first, the primary behind a planned
  handover) answers every query exactly once and ends bitwise;
* with quorum = every member, an ingest ack means every replica's log is
  fsynced through it;
* a real SIGKILL of a primary process that runs the port, over localhost
  TCP: the replica promotes itself and serves;
* the JAX cluster and the port's, driven through the same sequence, end
  with the same digests and the same failover;
* ``repro_torch.launch.serve --cluster 3 --device cpu`` holds its
  zero-downtime contract.

The ``cuda`` case runs a two-member cluster on the card.
"""
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import WoWIndex, make_workload
from repro_torch.persist import (
    ReplicaReplicator,
    SocketEndpoint,
    recover,
    state_digest,
    wal_dir,
)
from repro_torch.persist import wal as walmod
from repro_torch.serve.cluster import Cluster
from repro_torch.serve.lifecycle import EngineConfig, ServeEngine

KW = dict(m=8, ef_construction=32, o=4, seed=0)
CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def wl():
    return make_workload(n=400, d=12, nq=1, seed=0, with_gt=False)


def make_clock():
    T = [0.0]

    def now():
        return T[0]

    return T, now


def _mk_cluster(tmp_path, now, n=3, quorum=None, dim=12):
    roots = [str(tmp_path / f"m{i}") for i in range(n)]
    cfg = EngineConfig(k=4, width=16, max_wave=8, build_backend="numpy")
    return Cluster(roots, create=dict(dim=dim, **KW), config=cfg,
                   quorum=quorum, now=now, device=CPU)


def _ingest(c, wl, T, batches, size=20, start=0):
    lsns = []
    for b in range(batches):
        lo = start + size * b
        r = c.submit_ingest(wl.vectors[lo:lo + size], wl.attrs[lo:lo + size])
        lsns.append(r.lsn)
        for _ in range(10):
            T[0] += 0.01
            c.step()
    c.drain()
    return lsns


def _digests(c, digest=state_digest):
    return {nid: digest(m.replicator.index)
            for nid, m in c.members.items()
            if getattr(m.replicator, "index", None) is not None}


def _failover(c, wl, T, crids_of=lambda ts: {t.crid for t in ts}):
    """Kill the primary with 4 queries in flight and step until the
    failover has happened and all 4 are answered."""
    tickets = [c.submit(wl.vectors[i], (-1e9, 1e9), k=4) for i in range(4)]
    crids = crids_of(tickets)
    c.kill("n0")
    replies = []
    for _ in range(400):
        T[0] += 0.05
        replies.extend(c.step())
        if c.failovers and {r.crid for r in replies} >= crids:
            break
    return crids, replies


def test_cluster_failover_preserves_acked_and_serves(tmp_path, wl):
    """The heartbeat timeout promotes the most durable replica, every
    outstanding query is answered, every acked write survives, and the
    cluster takes new ingest under the new epoch."""
    T, now = make_clock()
    c = _mk_cluster(tmp_path, now)
    assert all(m.engine is None or m.engine.device == torch.device(CPU)
               for m in c.members.values())
    acked_lsn = _ingest(c, wl, T, batches=3)[-1]
    crids, replies = _failover(c, wl, T)
    got = [r.crid for r in replies]
    assert set(got) >= crids, "a query was lost in failover"
    assert len(got) == len(set(got)), "a query was answered twice"
    assert len(c.failovers) == 1 and not c.failovers[0]["planned"]
    new_p = c.members[c.primary_id]
    assert new_p.replicator.epoch == 1 and new_p.replicator.index._epoch == 1
    assert walmod.log_epoch(wal_dir(new_p.root)) == 1
    assert new_p.replicator._last_lsn >= acked_lsn, "acked write lost"
    promo = recover(str(tmp_path / "m0"),
                    upto_lsn=new_p.replicator.epoch_base, device=CPU)
    assert state_digest(promo) == state_digest(new_p.replicator.index)

    post = c.submit_ingest(wl.vectors[100:120], wl.attrs[100:120])
    assert post.lsn == acked_lsn + 1
    c.drain()
    d = _digests(c)
    assert len(set(d.values())) == 1, d


def test_cluster_rolling_restart_zero_downtime(tmp_path, wl):
    """Every member restarts with queries outstanding: every query gets
    exactly one reply, no member ends stale, all digests match."""
    T, now = make_clock()
    c = _mk_cluster(tmp_path, now)
    _ingest(c, wl, T, batches=3)
    tickets = [c.submit(wl.vectors[i], (-1e9, 1e9), k=4) for i in range(6)]
    crids = {t.crid for t in tickets}

    res = c.rolling_restart()
    replies = list(res["replies"]) + c.drain()
    got = [r.crid for r in replies]
    assert sorted(got) == sorted(set(got)), "duplicate replies"
    assert set(got) >= crids, "a query was dropped during rolling restart"
    assert [w for w, _ in res["events"]].count("restarted") == 3
    assert ("handover", c.primary_id) in res["events"]
    assert [f["planned"] for f in c.failovers] == [True]
    assert all(m.admitted and m.role != "down" for m in c.members.values())
    d = _digests(c)
    assert len(d) == 3 and len(set(d.values())) == 1, d

    c.submit_ingest(wl.vectors[200:220], wl.attrs[200:220])
    tk = c.submit(wl.vectors[0], (-1e9, 1e9), k=4)
    out = c.drain()
    assert any(r.crid == tk.crid for r in out)


def test_cluster_ingest_ack_is_quorum_durable(tmp_path, wl):
    """With quorum = all members, every replica's log is fsynced through
    the acked LSN the moment ``submit_ingest`` returns."""
    T, now = make_clock()
    c = _mk_cluster(tmp_path, now, quorum=3)
    res = c.submit_ingest(wl.vectors[:30], wl.attrs[:30])
    for nid, m in c.members.items():
        if nid == c.primary_id:
            continue
        assert m.replicator.durable_lsn >= res.lsn, \
            f"{nid} acked-but-not-durable"
        on_disk = walmod.read_log(wal_dir(m.root))
        assert on_disk and on_disk[-1][0] >= res.lsn


def test_cluster_device_none_is_the_card(tmp_path):
    """``Cluster(device=None)`` is the card and raises without CUDA."""
    if torch.cuda.is_available():
        c = Cluster([str(tmp_path / "a")], create=dict(dim=12, **KW))
        assert c.device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Cluster([str(tmp_path / "a")], create=dict(dim=12, **KW))
        assert not os.path.exists(tmp_path / "a")


def test_cluster_matches_jax_cluster(tmp_path, wl):
    """The JAX cluster and the port's, driven through the same ingest, kill
    and post-failover ingest on the same virtual clock, end with the same
    digests on every member, the same failover and the same routing."""
    from repro import persist as jp
    from repro.serve.cluster import Cluster as JCluster
    from repro.serve.lifecycle import EngineConfig as JConfig

    runs = {}
    for pkg, C, Cfg, digest, kw in (
            ("jax", JCluster, JConfig, jp.state_digest, {}),
            ("torch", Cluster, EngineConfig, state_digest, {"device": CPU})):
        T, now = make_clock()
        roots = [str(tmp_path / pkg / f"m{i}") for i in range(3)]
        c = C(roots, create=dict(dim=12, **KW), now=now,
              config=Cfg(k=4, width=16, max_wave=8, build_backend="numpy"),
              **kw)
        lsns = _ingest(c, wl, T, batches=3)
        crids, replies = _failover(c, wl, T)
        post = c.submit_ingest(wl.vectors[100:120], wl.attrs[100:120]).lsn
        c.drain()
        runs[pkg] = (lsns, post, sorted((r.crid, r.node) for r in replies),
                     [(f["node"], f["epoch"], f["planned"])
                      for f in c.failovers], _digests(c, digest))
    assert runs["jax"] == runs["torch"]


# ------------------------------------------------- real SIGKILL failover
def test_sigkill_primary_failover_promoted_replica_serves(tmp_path):
    """The primary is a real process running the port on the CPU,
    SIGKILLed mid-ingest.  The replica (this process, localhost TCP)
    bootstrapped from its checkpoint stream, holds every acked batch,
    promotes itself and serves, bitwise the dead primary's disk at the
    promotion LSN."""
    import time as wallclock

    proot = str(tmp_path / "primary")
    rroot = str(tmp_path / "replica")
    ep = SocketEndpoint("R")
    host, port = ep.addr
    rep = ReplicaReplicator(rroot, ep, "R", device=CPU)
    rep.start()

    child = f"""
import os, signal
from repro_torch.core import make_workload
from repro_torch.persist import open_durable
from repro_torch.persist.replicate import PrimaryReplicator, SocketEndpoint
wl = make_workload(n=240, d=12, nq=1, seed=7, with_gt=False)
idx = open_durable({proot!r}, create=dict(dim=12, m=8, ef_construction=32,
                                          o=4, seed=0), device="cpu")
ep = SocketEndpoint("P")
ep.connect("R", ({host!r}, {port}))
prim = PrimaryReplicator(idx, {proot!r}, ep, node_id="P", quorum=2,
                         idle_s=0.0005)
prim.attach()
for i in range(6):
    idx.insert_batch(wl.vectors[40*i:40*(i+1)], wl.attrs[40*i:40*(i+1)],
                     batch_size=40, backend="numpy")
    print("ACK", i, flush=True)
    if i == 3:
        os.kill(os.getpid(), signal.SIGKILL)
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", child],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    deadline = wallclock.time() + 240
    while proc.poll() is None and wallclock.time() < deadline:
        rep.pump()
        wallclock.sleep(0.001)
    out, err = proc.communicate(timeout=30)
    assert proc.returncode == -signal.SIGKILL, err
    acked = out.count("ACK")
    assert acked == 4, out
    for _ in range(200):
        rep.pump()
        wallclock.sleep(0.001)

    assert rep.index is not None and rep.durable_lsn >= acked
    wallclock.sleep(rep.heartbeat_timeout_s + 0.1)
    assert not rep.primary_alive()

    assert rep.promote() == 1
    assert walmod.log_epoch(wal_dir(rroot)) == 1

    rec = recover(proot, upto_lsn=rep.index._applied_lsn, device=CPU)
    assert state_digest(rec) == state_digest(rep.index)
    want = WoWIndex(dim=12, device=CPU, **KW)
    wl7 = make_workload(n=240, d=12, nq=1, seed=7, with_gt=False)
    for i in range(acked):
        want.insert_batch(wl7.vectors[40 * i:40 * (i + 1)],
                          wl7.attrs[40 * i:40 * (i + 1)],
                          batch_size=40, backend="numpy")
    assert state_digest(rep.index) == state_digest(want)

    eng = ServeEngine(index=rep.index, device=CPU,
                      config=EngineConfig(k=4, width=16, max_wave=8,
                                          build_backend="numpy"))
    eng.submit(wl7.vectors[0], (-1e9, 1e9), k=4)
    replies = eng.drain()
    assert len(replies) == 1 and replies[0].ids[0] >= 0
    ep.close()


# -------------------------------------------------------------- launcher
def test_launcher_cluster_zero_downtime(tmp_path):
    """``--cluster 3 --device cpu`` ingests through the primary, rolls
    every member mid-stream and answers every query."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--cluster", "3",
         "--device", "cpu", "--n", "300", "--dim", "12", "--queries", "24",
         "--k", "4", "--width", "16", "--m", "8", "--ef-construction", "32",
         "--max-wave", "8", "--index-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "zero-downtime contract held" in res.stdout
    assert "restarted:n0" in res.stdout and "handover:n1" in res.stdout
    assert "served 24/24 queries" in res.stdout
    assert sorted(os.listdir(tmp_path)) == ["member0", "member1", "member2"]


def test_launcher_cluster_is_its_own_mode():
    from repro_torch.launch.serve import main

    for extra in (["--engine"], ["--backend", "ref", "auto"],
                  ["--compact", "8,8"]):
        with pytest.raises(SystemExit):
            main(["--cluster", "3", "--device", "cpu", *extra])


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
def test_cuda_cluster_bitwise_and_failover(cuda_device, tmp_path):
    """On the card, two members (``device=None``), the device build and
    the kernel: after quorum-durable ingest every replica's log ends at
    the last ack and both digests are equal; after ``warmup()`` every
    reply equals the kernel's ``search_batch`` bit for bit with no graph
    captured; a killed primary with queries in flight fails over to epoch
    1, answers each query exactly once and equals the dead primary's disk
    at the promotion LSN."""
    from repro_torch.core import device_search as tds
    from repro_torch.core.device_search import search_batch
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.kernels import launch_counters

    def gnd():
        return sum(c.get("gather_norm_dot", 0) for c in launch_counters())

    wl = make_workload(n=400, d=12, nq=32, seed=0, k=5)
    T, now = make_clock()
    roots = [str(tmp_path / f"m{i}") for i in range(2)]
    cfg = EngineConfig(k=5, width=32, max_wave=16, backend="cuda",
                       build_backend="device", adaptive=False)
    c = Cluster(roots, create=dict(dim=12, **KW), config=cfg, now=now)
    assert c.quorum == 2 and c.device == torch.device("cuda")
    g0 = gnd()
    lsns = _ingest(c, wl, T, batches=4, size=100)
    assert gnd() > g0
    acked = lsns[-1]
    rep = c.members["n1"].replicator
    assert rep.durable_lsn >= acked
    assert walmod.read_log(wal_dir(roots[1]))[-1][0] == acked
    d = _digests(c)
    assert len(d) == 2 and len(set(d.values())) == 1, d

    c.warmup()
    caps = tds.GRAPH_CAPTURES["chunks"]
    snap = take_snapshot(c.members["n0"].replicator.index)
    ref = search_batch(snap, wl.queries, wl.ranges, k=5, width=32,
                       backend="cuda", device="cuda")
    crid_qi = {c.submit(wl.queries[i], wl.ranges[i]).crid: i
               for i in range(len(wl.queries))}
    replies = c.drain()
    assert tds.GRAPH_CAPTURES["chunks"] == caps
    assert sorted(r.crid for r in replies) == sorted(crid_qi)
    assert {r.node for r in replies} == {"n0", "n1"}
    for r in replies:
        i = crid_qi[r.crid]
        want = np.where(ref.ids[i] >= 0,
                        snap.ids_map[np.clip(ref.ids[i], 0, None)], -1)
        np.testing.assert_array_equal(r.reply.ids, want)
        np.testing.assert_array_equal(r.reply.dists, ref.dists[i])
        assert (r.reply.hops, r.reply.dc) == (ref.hops[i], ref.dc[i])

    crids, replies = _failover(c, wl, T)
    got = [r.crid for r in replies]
    assert set(got) == crids and len(got) == len(crids)
    assert [(f["node"], f["epoch"], f["planned"]) for f in c.failovers] \
        == [("n1", 1, False)]
    assert walmod.log_epoch(wal_dir(roots[1])) == 1
    prim = c.members["n1"].replicator
    assert prim._last_lsn >= acked
    assert state_digest(recover(roots[0], upto_lsn=prim.epoch_base)) == \
        state_digest(prim.index)
