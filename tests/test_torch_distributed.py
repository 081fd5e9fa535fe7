"""The sharded build and mesh serving of the port
(``insert_batch(backend="sharded")``, ``repro_torch.core.distributed``,
``repro_torch.parallel``) on the CPU, against the port's own device build
and lock-step ``search_batch`` (bitwise) and against the JAX package.

  * ``sharded`` at one shard in this process, and at 2 and 4 ranks (int8
    at 2) in spawned gloo ranks (``_torch_ranks``): every rank's graph and
    ``state_digest`` equal the port's device build, every rank's arena
    holds the same bytes, and Def. 4 holds on every fresh vertex;
  * band recall within 0.01 (int8 0.03) of the JAX package's
    ``insert_batch(backend="sharded", shards=1)`` on the same stream;
  * ``make_serving_fn`` at 1 x 1 bitwise the lock-step ``search_batch``
    and under the tie rule the JAX ``make_serving_fn``; at 2 x 2 (four
    ranks) the 1 x 1 results, hop histogram and filter sizes;
  * a sharded insert's WAL segment byte-equal to the JAX package's, its
    replay (on the device build) to the same ``state_digest``;
  * the launcher's ``--build-shards``/``--mesh`` lines equal the JAX
    launcher's, in this process and on two ``torchrun`` ranks.

Whole device builds of the two packages are held by recall, not bitwise
(one ulp can flip a neighbor choice, ``test_torch_device_build``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as rc
from repro.core import distributed as rdist
from repro_torch import core as tc
from repro_torch import persist as tp
from repro_torch.core import device_search as tds
from repro_torch.core import distributed as tdist
from repro_torch.parallel import serving_mesh

from _invariants import (
    assert_band_parity,
    assert_graph_equal,
    assert_window_invariants,
    band_recalls,
)
from _torch_ranks import four_ranks, graph_of, run_ranks, two_ranks
from _workloads import make_regime_workload
from test_torch_kernels import cuda_device  # noqa: F401  (the fixture)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
KW = dict(m=8, ef_construction=32, o=4, seed=0)
N, D, BS = 320, 16, 80
SERVE_KW = dict(k=10, width=32, visited="hash", visited_adaptive=True)


@pytest.fixture(scope="module")
def wl():
    return make_regime_workload("random", n=N, d=D, nq=24, seed=0, k=10)


def _device_build(wl, vec_dtype):
    idx = tc.WoWIndex(dim=D, vec_dtype=vec_dtype, device=CPU, **KW)
    for s in range(0, N, BS):
        idx.insert_batch(wl.vectors[s:s + BS], wl.attrs[s:s + BS],
                         batch_size=BS, backend="device")
    return idx


@pytest.fixture(scope="module")
def device_builds(wl):
    return {vd: _device_build(wl, vd) for vd in ("f32", "int8")}


@pytest.fixture(scope="module")
def one_shard(wl):
    """In-process ``sharded`` builds at one shard, in micro-batch calls,
    with Def. 4 checked on the fresh vertices of every call."""
    out = {}
    for vd in ("f32", "int8"):
        idx = tc.WoWIndex(dim=D, vec_dtype=vd, device=CPU, **KW)
        for s in range(0, N, BS):
            vids = idx.insert_batch(wl.vectors[s:s + BS], wl.attrs[s:s + BS],
                                    batch_size=BS, backend="sharded",
                                    shards=1)
            assert_window_invariants(idx, vids)
        out[vd] = idx
    return out


def _build_args(wl, vd):
    return (wl.vectors, wl.attrs, BS, KW, vd)


@pytest.fixture(scope="module")
def ranks2(wl, tmp_path_factory):
    return run_ranks(two_ranks, 2, tmp_path_factory.mktemp("r2"),
                     [_build_args(wl, "f32"), _build_args(wl, "int8")], 4)


@pytest.fixture(scope="module")
def snap(device_builds):
    from repro_torch.core.snapshot import take_snapshot

    return take_snapshot(device_builds["f32"])


@pytest.fixture(scope="module")
def ranks4(wl, snap, tmp_path_factory):
    return run_ranks(four_ranks, 4, tmp_path_factory.mktemp("r4"),
                     _build_args(wl, "f32"),
                     (snap, wl.queries, wl.ranges, 2, 2, SERVE_KW))


def _assert_same_build(got: dict, ref_idx, label: str) -> None:
    ref = graph_of(ref_idx)
    assert len(got["layers"]) == len(ref["layers"]), label
    for l, (a, b) in enumerate(zip(got["layers"], ref["layers"])):
        assert np.array_equal(a, b), f"{label}: layer {l} adjacency"
    for l, (a, b) in enumerate(zip(got["counts"], ref["counts"])):
        assert np.array_equal(a, b), f"{label}: layer {l} degree counts"
    assert got["digest"] == ref["digest"], label


# ----------------------------------------------------------------- build
@pytest.mark.parametrize("vec_dtype", ["f32", "int8"])
def test_sharded_one_shard_bitwise_device(one_shard, device_builds,
                                          vec_dtype):
    """At one shard the sharded build is the device build bit for bit
    (Def. 4 was checked on every fresh vertex as it was built)."""
    idx, dev = one_shard[vec_dtype], device_builds[vec_dtype]
    assert idx._arena.num_shards == 1 and idx._arena.stats["searches"] > 0
    assert idx._arena.stats["rows_scattered"] > 0  # delta-maintained
    assert_graph_equal(idx, dev, f"sharded@1/{vec_dtype} vs device")
    assert tp.state_digest(idx) == tp.state_digest(dev)


@pytest.mark.parametrize("case", [(2, "f32"), (2, "int8"), (4, "f32")],
                         ids=lambda c: f"{c[0]}ranks-{c[1]}")
def test_sharded_ranks_bitwise_device(ranks2, ranks4, device_builds, wl,
                                      case):
    """On 2 and 4 gloo ranks every rank commits the device build's graph
    and digest, and every rank's arena holds the same bytes."""
    world, vd = case
    builds = ([r["builds"][0 if vd == "f32" else 1] for r in ranks2]
              if world == 2 else [r["build"] for r in ranks4])
    for r, got in enumerate(builds):
        assert got["rank"] == r and got["num_shards"] == world
        assert got["stats"]["searches"] > 0
        _assert_same_build(got, device_builds[vd],
                           f"sharded@{world}/{vd} rank {r}")
    assert len({got["arena"] for got in builds}) == 1
    # every rank's fresh ids are the stream's, in order
    assert np.array_equal(np.concatenate(builds[0]["vids"]), np.arange(N))


@pytest.mark.parametrize("vec_dtype", ["f32", "int8"])
def test_band_recall_parity_vs_jax_sharded(one_shard, wl, vec_dtype):
    """Band recall of the port's sharded build within 0.01 (int8: 0.03)
    of the JAX package's sharded build on the same stream."""
    ri = rc.WoWIndex(dim=D, vec_dtype=vec_dtype, **KW)
    ri.insert_batch(wl.vectors, wl.attrs, batch_size=BS, backend="sharded",
                    shards=1)
    tol = 0.03 if vec_dtype == "int8" else 0.01
    assert_band_parity(band_recalls(ri, wl),
                       band_recalls(one_shard[vec_dtype], wl),
                       tol=tol, label=f"sharded/{vec_dtype}")


def test_shard_count_errors(ranks2, wl):
    """``shards=`` only with ``"sharded"``; ``device_width=`` only with
    ``"device"``/``"sharded"``; a mesh of more ranks than the world (or
    with no process group) raises and says how to start ranks."""
    idx = tc.WoWIndex(dim=D, device=CPU, **KW)
    with pytest.raises(ValueError, match="shards= applies only"):
        idx.insert_batch(wl.vectors[:8], wl.attrs[:8], shards=2)
    with pytest.raises(ValueError, match="device_width= applies only"):
        idx.insert_batch(wl.vectors[:8], wl.attrs[:8], backend="ops",
                         device_width=8)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        idx.insert_batch(wl.vectors[:8], wl.attrs[:8], backend="sharded",
                         shards=2)
    assert idx.store.n == 0
    for r in ranks2:
        assert "needs world size 4" in r["error"], r["error"]
        assert "torchrun --nproc-per-node 4" in r["error"]


@pytest.mark.parametrize("vec_dtype", ["f32", "int8", "bf16"])
def test_gather_twin_rows_batch_independent(vec_dtype):
    """A rank searches a slice of the batch, so the plain twin of
    ``gather_norm_dot`` must give a row the same bits in any batch, as the
    kernel does; so must the query norms of the hop loop's init."""
    import torch

    from repro_torch.core.device_search import _row_sq
    from repro_torch.kernels.ref import gather_norm_dot_ref

    rng = np.random.default_rng(5)
    for D, K in ((16, 9), (32, 17), (128, 33)):
        f32 = rng.standard_normal((500, D)).astype(np.float32)
        table = torch.from_numpy(f32)
        scales = None
        if vec_dtype == "int8":
            table = (table * 40).clamp(-127, 127).to(torch.int8)
            scales = torch.from_numpy(rng.random(500).astype(np.float32))
        elif vec_dtype == "bf16":
            table = table.to(torch.bfloat16)
        ids = torch.from_numpy(rng.integers(0, 500, (128, K)))
        q = torch.from_numpy(rng.standard_normal((128, D)).astype(np.float32))
        full = gather_norm_dot_ref(table, ids, q, scales)
        q2 = _row_sq(q)
        for s in (1, 3, 8, 64):
            for lo in range(0, 128, s):
                part = gather_norm_dot_ref(table, ids[lo:lo + s],
                                           q[lo:lo + s], scales)
                for a, b in zip(part, full):
                    assert torch.equal(a, b[lo:lo + s]), (D, K, s, lo)
                assert torch.equal(_row_sq(q[lo:lo + s]), q2[lo:lo + s])


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_serving_one_by_one_bitwise_search_batch(snap, wl, visited):
    """At 1 x 1 the serving function is the lock-step ``search_batch``
    bit for bit, and its histogram is that of ``search_batch``'s hops."""
    fn = tdist.make_serving_fn(serving_mesh(1, 1, device=CPU), snap, k=10,
                               width=32, visited=visited,
                               visited_adaptive=True)
    bits = fn.state["bits"]
    got = fn(wl.queries, wl.ranges)
    exp = tds.search_batch(snap, wl.queries, wl.ranges, k=10, width=32,
                           visited=visited, visited_bits=bits, device=CPU)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
    H = len(fn.state["hist"]) - 1
    np.testing.assert_array_equal(
        fn.state["hist"], np.bincount(np.clip(exp.hops, 0, H), minlength=H + 1))


def test_serving_one_by_one_matches_jax(snap, wl):
    """The port's 1 x 1 serving function against the JAX one over the same
    snapshot, under the tie rule, with the same adaptive filter sizes and
    histogram."""
    from repro.launch.mesh import make_host_mesh

    got = tdist.make_serving_fn(serving_mesh(1, 1, device=CPU), snap,
                                **SERVE_KW)
    exp = rdist.make_serving_fn(make_host_mesh((1, 1), ("data", "model")),
                                snap, **SERVE_KW)
    scale = float(snap.sq_norms.max() + (wl.queries**2).sum(1).max())
    for _ in range(2):
        a = got(wl.queries, wl.ranges)
        b = tds.SearchResult(*(np.asarray(x)
                               for x in exp(wl.queries, wl.ranges)))
        rep = tds.compare_results(a, b, scale=scale)
        assert rep["faults"] == [] and not rep["tie_flips"], rep
        assert got.state["bits"] == exp.state["bits"]
    np.testing.assert_array_equal(got.state["hist"], exp.state["hist"])


def test_serving_two_by_two_matches_one_by_one(ranks4, snap, wl):
    """On a 2 x 2 mesh (four ranks) every rank returns the 1 x 1 results,
    and the histogram counts each query once (not once per model rank)."""
    one = tdist.make_serving_fn(serving_mesh(1, 1, device=CPU), snap,
                                **SERVE_KW)
    waves = [tuple(one(wl.queries, wl.ranges)) for _ in range(2)]
    assert int(one.state["hist"].sum()) == 2 * len(wl.queries)
    assert sorted(r["serve"]["coord"] for r in ranks4) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks4:
        got = r["serve"]
        for w, exp in zip(got["waves"], waves):
            for a, b in zip(w, exp):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["hist"], one.state["hist"])
        assert got["bits"][-1] == one.state["bits"]


def test_partition_bounds_matches_jax():
    for n in (1, 7, 100, 257):
        for parts in (1, 2, 3, 4, 8):
            for halo in (0, 1, 5, 64):
                a = np.arange(n)
                assert tdist.partition_bounds(a, parts, halo) == \
                    rdist.partition_bounds(a, parts, halo), (n, parts, halo)


# -------------------------------------------------------------------- WAL
def test_sharded_wal_byte_equal_and_replays(tmp_path, wl):
    """Sharded inserts log the JAX package's bytes (backend "sharded",
    shards 1), and the port replays them on the device build to the live
    index's digest."""
    from repro.persist import open_durable as ref_open
    from repro_torch.persist import wal as twal

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    ri = ref_open(jroot, create=dict(dim=D, **KW))
    ti = tp.open_durable(troot, create=dict(dim=D, **KW), device=CPU)
    for idx in (ri, ti):
        idx.insert_batch(wl.vectors[:160], wl.attrs[:160], batch_size=80)
        idx.insert_batch(wl.vectors[160:240], wl.attrs[160:240],
                         batch_size=40, backend="sharded", shards=1)
        idx._wal.close()
    jsegs = twal.list_segments(tp.wal_dir(jroot))
    tsegs = twal.list_segments(tp.wal_dir(troot))
    assert [s for s, _ in jsegs] == [s for s, _ in tsegs]
    for (_, a), (_, b) in zip(jsegs, tsegs):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    heads = [twal.unpack_insert(p)[2] for _, t, p in
             twal.read_log(tp.wal_dir(troot)) if t == twal.T_INSERT]
    assert [(h["backend"], h["shards"]) for h in heads] == [
        ("numpy", None)] * 2 + [("sharded", 1)] * 2
    assert tp.state_digest(tp.recover(troot, device=CPU)) == \
        tp.state_digest(ti)


# --------------------------------------------------------------- launcher
LAUNCH = ["--n", "600", "--dim", "16", "--queries", "24", "--width", "32",
          "--m", "8", "--ef-construction", "32", "--build-backend",
          "sharded"]


def _served_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines()
            if ln.startswith(("served ", "hops-to-termination"))]


@pytest.fixture(scope="module")
def jax_lines():
    """The JAX launcher's recall/DC/hop lines for the sharded build at one
    shard served on a 1 x 1 mesh."""
    import contextlib
    import io

    from repro.launch import serve as jserve

    argv, buf = sys.argv, io.StringIO()
    sys.argv = ["serve", *LAUNCH, "--build-shards", "1", "--mesh", "1x1"]
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = argv
    lines = _served_lines(buf.getvalue())
    assert len(lines) == 2, buf.getvalue()
    return lines


def test_launcher_mesh_lines_match_jax(jax_lines, capsys):
    from repro_torch.launch import serve

    out = serve.main([*LAUNCH, "--build-shards", "1", "--mesh", "1x1",
                      "--device", CPU])
    assert _served_lines(capsys.readouterr().out) == jax_lines
    assert out["mesh"]["shape"] == (1, 1)
    assert out["index"]._arena.num_shards == 1


def test_launcher_two_ranks_torchrun(jax_lines):
    """``torchrun`` (two CPU ranks, a free rendezvous port) at ``--mesh
    2x1`` with the sharded build on both ranks: rank 0 alone prints, and
    it prints the JAX launcher's lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         *LAUNCH, "--mesh", "2x1", "--device", CPU],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("indexed 600 vectors") == 1, res.stdout
    assert _served_lines(res.stdout) == jax_lines, res.stdout


@pytest.mark.parametrize("extra,msg", [
    (["--build-shards", "2", "--build-backend", "device"],
     "--build-shards requires --build-backend sharded"),
    (["--mesh", "1x1", "--engine"], "one mode or the other"),
    (["--mesh", "1x1", "--cluster", "3"], "one mode or the other"),
    (["--mesh", "1x1", "--compact", "8,8", "4,4"], "lock-step loop"),
    (["--mesh", "1x1", "--visited", "bitmap", "hash"],
     "one configuration"),
])
def test_launcher_mesh_errors(extra, msg, capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(["--device", CPU, *extra])
    assert msg in capsys.readouterr().err


# --------------------------------------------------------------- the card
@pytest.mark.cuda
def test_cuda_sharded_one_shard_bitwise_device(cuda_device, wl):
    """On the card (the kernel on both sides) the sharded build at one
    shard is the device build bit for bit."""
    from repro_torch.kernels.gather_distance import LAUNCHES

    builds = []
    for backend, extra in (("device", {}), ("sharded", {"shards": 1})):
        idx = tc.WoWIndex(dim=D, device=cuda_device, **KW)
        before = LAUNCHES["gather_norm_dot"]
        idx.insert_batch(wl.vectors, wl.attrs, batch_size=BS,
                         backend=backend, **extra)
        assert LAUNCHES["gather_norm_dot"] > before
        builds.append(idx)
    assert_graph_equal(*builds, "sharded@1 vs device on the card")
    assert tp.state_digest(builds[0]) == tp.state_digest(builds[1])
