"""repro_torch device-resident build (``insert_batch(backend="device" |
"ops")``, ``DeviceBuildArena``, ``build_search``) vs the JAX package's.

  * ``build_search`` on one arena state, uploaded from the same host graph
    in both packages: ids, DC and hops under the tie rule of
    ``compare_results`` (dists within 1e-5 of the term size |v|^2 + |q|^2);
  * per micro-batch, the delta-updated arena equals a full re-upload and
    the host arenas bitwise;
  * whole builds against the JAX package's same backend: per-band recall
    within 0.01 (0.03 for int8 slabs) and the Def. 4 window invariants.
    One ulp of a distance can flip a neighbor choice and cascade through
    later micro-batches, so whole builds are held by recall and
    invariants, not bitwise;
  * the no-Theta(n)-work gate of the device batch loop, and the ops host
    search against the numpy one.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.snapshot import DeviceBuildArena as RefArena
from repro_torch import core as tc
from repro_torch.core import device_search as tds
from repro_torch.core.search import search_candidates_batch
from repro_torch.core.snapshot import DeviceBuildArena
from repro_torch.core.store import quantize_rows

from _invariants import (
    assert_band_parity,
    assert_degree_bounds,
    assert_graph_equal,
    assert_window_invariants,
    band_recalls,
)
from test_torch_kernels import cuda_device  # noqa: F401  (the fixture)

CPU = "cpu"
KW = dict(m=8, ef_construction=32, o=4, seed=0)


@pytest.fixture(scope="module")
def wl():
    return rc.make_workload(n=400, d=16, nq=24, seed=0, k=10)


# ----------------------------------------------------- one build search
@pytest.fixture(scope="module")
def arenas(wl):
    """Both packages' arenas over the same (bitwise-equal) host graph, and
    a micro-batch of search inputs: windows around each member's value,
    sampled entries, and a carry for half the members."""
    ti = tc.WoWIndex(dim=16, device=CPU, **KW)
    ri = rc.WoWIndex(dim=16, **KW)
    ti.insert_batch(wl.vectors[:360], wl.attrs[:360], batch_size=120)
    ri.insert_batch(wl.vectors[:360], wl.attrs[:360], batch_size=120)
    assert_graph_equal(ti, ri, "host build")
    ta, ra = DeviceBuildArena(device=CPU), RefArena()
    ta.ensure(ti)
    ra.ensure(ri)
    rng = np.random.default_rng(5)
    B, n = 40, 360
    targets = wl.vectors[360:400].astype(np.float32)
    val = wl.attrs[360:400]
    span = rng.uniform(20, 200, size=B)
    ranges = np.stack([val - span, val + span], axis=1)
    eps = rng.integers(0, n, size=B)
    d = ((wl.vectors[:n][None] - targets[:, None]) ** 2).sum(-1)
    seed_ids = np.argsort(d, axis=1)[:, :12].astype(np.int64)
    seed_d = np.take_along_axis(d, seed_ids, 1).astype(np.float64)
    seed_ids[::2] = -1  # even members: no carry -> sampled entry
    seed_d[::2] = np.inf
    scale = float((wl.vectors[:n] ** 2).sum(1).max()
                  + (targets**2).sum(1).max())
    return ti, ta, ra, (targets, ranges, eps, seed_ids, seed_d), scale


@pytest.mark.parametrize("compact", [None, (8, 8)])
@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_build_search_matches_jax(arenas, visited, compact):
    from repro.core.device_search import build_search as ref_build_search

    ti, ta, ra, (targets, ranges, eps, si, sd), scale = arenas
    top = ti.graph.top
    for l_lo in (0, top):
        kw = dict(width=32, m=8, o=4, seed_width=12, visited=visited,
                  compact=compact)
        got = tds.build_search(ta.device_index(), targets, ranges, eps,
                               l_lo, top, si, sd, backend="ref", **kw)
        exp = ref_build_search(ra.device_index(), targets, ranges, eps,
                               l_lo, top, si, sd, backend="ref", **kw)
        got = tds.SearchResult(*got)
        exp = tds.SearchResult(*(np.asarray(a) for a in exp))
        rep = tds.compare_results(got, exp, scale=scale)
        assert rep["faults"] == [] and len(rep["tie_flips"]) <= 1, rep
        assert got.ids.shape == (40, 32) and (got.dc > 0).all()


def test_build_search_masks_deleted(arenas):
    ti, ta, _, (targets, ranges, eps, si, sd), _ = arenas
    top = ti.graph.top
    base = tds.build_search(ta.device_index(), targets, ranges, eps, 0, top,
                            si, sd, width=32, m=8, o=4)
    dead = {int(i) for i in base[0][:, 0] if i >= 0}
    got = tds.build_search(ta.device_index(), targets, ranges, eps, 0, top,
                           si, sd, width=32, m=8, o=4, deleted=dead)
    assert not np.isin(got[0], list(dead)).any()
    # deleted ids stay traversable: the searches themselves are unchanged
    np.testing.assert_array_equal(got[2], base[2])
    np.testing.assert_array_equal(got[3], base[3])


# ---------------------------------------------------------- the arena
def _stack(idx):
    return np.stack([lay for lay in idx.graph.layers], axis=0)


@pytest.mark.parametrize("vec_dtype", ["f32", "int8", "bf16"])
def test_delta_arena_equals_full_upload_per_micro_batch(wl, vec_dtype):
    """After every micro-batch the delta-updated arena is bitwise a fresh
    full upload of the index, and mirrors the host arenas."""
    idx = tc.WoWIndex(dim=16, vec_dtype=vec_dtype, device=CPU, **KW)
    bs = 64
    checked = 0
    for s in range(0, 400, bs):
        idx.insert_batch(wl.vectors[s:s + bs], wl.attrs[s:s + bs],
                         batch_size=bs, backend="device")
        arena = idx._arena
        if arena.neighbors is None:
            continue  # bootstrap batch: no pre-batch graph to mirror
        arena.ensure(idx)  # append this batch's rows, as the next one would
        fresh = DeviceBuildArena(vec_dtype=vec_dtype, device=CPU)
        fresh.ensure(idx)
        for f in ("vectors", "sq_norms", "attrs", "neighbors", "q_scales"):
            a, b = getattr(arena, f), getattr(fresh, f)
            if a is None:
                assert b is None and vec_dtype != "int8"
                continue
            assert a.dtype == b.dtype and torch.equal(a.view(-1).view(
                torch.uint8), b.view(-1).view(torch.uint8)), f
        n = idx.store.n
        assert np.array_equal(arena.neighbors.numpy()[:, :idx.graph.capacity],
                              _stack(idx))
        slab, _ = quantize_rows(idx.store.vectors[:n], vec_dtype)
        got = arena.vectors[:n]
        if vec_dtype == "bf16":
            got = got.view(torch.int16).numpy().view(np.uint16)
        else:
            got = got.numpy()
        assert np.array_equal(got, slab)
        assert arena.nbytes() > 0
        checked += 1
    assert checked >= 4 and idx._arena.stats["full_uploads"] >= 1


def test_no_theta_n_work_in_device_batch_loop(wl):
    """Across >= 3 consecutive device micro-batches (no capacity or top
    growth) the arena is uploaded once and updated by deltas since."""
    idx = tc.WoWIndex(dim=16, device=CPU, **KW)
    idx.insert_batch(wl.vectors[:200], wl.attrs[:200], batch_size=100)
    idx.insert_batch(wl.vectors[200:260], wl.attrs[200:260], batch_size=60,
                     backend="device")
    arena = idx._arena
    uploads = arena.stats["full_uploads"]
    scattered = arena.stats["rows_scattered"]
    nb = arena.neighbors
    top0 = idx.graph.top
    for s in range(260, 400, 35):
        idx.insert_batch(wl.vectors[s:s + 35], wl.attrs[s:s + 35],
                         batch_size=35, backend="device")
    assert idx.graph.top == top0, "layer growth would void the invariant"
    assert idx._arena is arena and arena.neighbors is nb  # in place
    assert arena.stats["full_uploads"] == uploads
    assert arena.stats["rows_scattered"] > scattered
    assert arena.stats["rows_appended"] >= 105
    assert arena.stats["searches"] > 0


# ------------------------------------------------------------ whole builds
@pytest.mark.parametrize("backend,vec_dtype,n,bs", [
    ("device", "f32", 320, 80),
    ("device", "int8", 320, 80),
    ("ops", "f32", 200, 100),
    ("ops", "int8", 200, 100),
])
def test_insert_batch_matches_jax_backend(wl, backend, vec_dtype, n, bs):
    tol = 0.03 if vec_dtype == "int8" else 0.01
    sub = rc.make_workload(n=n, d=16, nq=24, seed=0, k=10)
    ti = tc.WoWIndex(dim=16, vec_dtype=vec_dtype, device=CPU, **KW)
    ri = rc.WoWIndex(dim=16, vec_dtype=vec_dtype, **KW)
    for s in range(0, n, bs):  # Def. 4 holds against each post-batch WBT
        vids = ti.insert_batch(sub.vectors[s:s + bs], sub.attrs[s:s + bs],
                               batch_size=bs, backend=backend)
        assert_window_invariants(ti, vids)
    ri.insert_batch(sub.vectors, sub.attrs, batch_size=bs, backend=backend)
    assert ti.build_stats.searches > 0 and ti._arena is not None
    assert_band_parity(band_recalls(ri, sub), band_recalls(ti, sub),
                       tol=tol, label=f"{backend}/{vec_dtype}")
    assert_degree_bounds(ti)


def test_ops_search_matches_numpy_search(wl):
    """The ops host search (fused gather dispatch on the arena table) and
    the numpy one admit and rank alike."""
    idx = tc.WoWIndex(dim=16, device=CPU, **KW)
    idx.insert_batch(wl.vectors[:360], wl.attrs[:360], batch_size=120)
    arena = DeviceBuildArena(device=CPU)
    arena.ensure(idx)
    rng = np.random.default_rng(9)
    B = 24
    targets = wl.vectors[360:384]
    ranges = np.sort(rng.uniform(0, 400, size=(B, 2)), axis=1)
    ranges[:, 1] += 50
    eps = np.asarray([int(np.argmin(np.abs(wl.attrs[:360] - r.mean())))
                      for r in ranges])
    kw = dict(l_min=0, l_max=idx.graph.top, width=32)
    a = search_candidates_batch(idx.store, idx.graph, targets, eps, ranges,
                                **kw)
    b = search_candidates_batch(idx.store, idx.graph, targets, eps, ranges,
                                backend="ops", ops_table=arena.vectors, **kw)
    c = search_candidates_batch(idx.store, idx.graph, targets, eps, ranges,
                                backend="ops", device=CPU, **kw)
    scale = float((wl.vectors**2).sum(1).max() * 2)
    for other in (b, c):
        rep = tds.compare_results(tds.SearchResult(*a[:4]),
                                  tds.SearchResult(*other[:4]), scale=scale)
        assert rep["faults"] == [] and len(rep["tie_flips"]) <= 1, rep


@pytest.mark.cuda
@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_cuda_graphed_chunks_match_eager(cuda_device, arenas, visited):
    """On the card the compaction driver replays captured CUDA graphs of
    its hop chunks: a replayed chunk of a construction search equals the
    eager ``_run_hops`` from the same state bitwise, twice over, and
    neither the capture nor a replay adds to the wrapper's launch count
    (``GRAPH_REPLAYS`` counts the replays, ``KERNEL_REPLAYS`` the kernel
    launches they ran: one a hop)."""
    from repro_torch.kernels.gather_distance import LAUNCHES

    ti, _, _, (targets, ranges, eps, si, sd), _ = arenas
    arena = DeviceBuildArena(device=cuda_device)
    arena.ensure(ti)
    prep = tds._prep_build_inputs(
        arena.device_index(), targets, ranges, eps, 0, ti.graph.top, si, sd,
        width=32, m=8, o=4, metric="l2", seed_width=None, backend="auto",
        visited=visited, visited_bits=None, visited_fp=0.02,
        visited_hashes=2, merge="auto", max_hops=None)
    st = tds._init_build_state(prep.di, *prep.args, prep.cfg)

    def fresh():
        return st._replace(**{f: getattr(st, f).clone()
                              for f in tds._STATE_TENSORS})

    h = 8
    eager = tds._run_hops(prep.di, fresh(), prep.cfg, h)  # also warms up
    launches, replays = LAUNCHES["gather_norm_dot"], dict(tds.GRAPH_REPLAYS)
    kernel_replays = dict(tds.KERNEL_REPLAYS)
    chunk = tds._GraphedChunk(prep.di, prep.cfg, fresh(), h)
    for i in (1, 2):
        graphed = chunk.run(fresh())
        assert graphed.t == st.t + h
        for f in tds._STATE_TENSORS:
            assert torch.equal(getattr(graphed, f), getattr(eager, f)), f
        assert tds.GRAPH_REPLAYS == {"chunks": replays["chunks"] + i,
                                     "hops": replays["hops"] + i * h}
        assert tds.KERNEL_REPLAYS == {
            "gather_norm_dot": kernel_replays["gather_norm_dot"] + i * h,
            "batched_dot": kernel_replays["batched_dot"]}
    assert LAUNCHES["gather_norm_dot"] == launches
