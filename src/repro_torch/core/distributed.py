"""Distributed WoW serving and building over ``torch.distributed`` ranks.

The JAX package runs both under one controller (``shard_map`` and a
sharding-annotated ``jit`` over a device mesh).  Here every rank is its own
process on its own device (``repro_torch.parallel``): the ranks run the same
program, each on its share of the batch, and meet in one host all-gather
per search.

Serving topology (the deployment for an index that fits one device):
queries are sharded over the ``data`` axis of a ``(data, model)`` mesh; the
snapshot (graph + vectors) is held whole by every rank.  Each rank runs the
batched beam search on its data shard (no collective inside the hop loop,
linear scaling in ranks), then the shards' results are all-gathered so that
every rank returns the global ``SearchResult``.  The ``model`` ranks of a
data group search the same shard, as the JAX version replicates the search
over ``model``.  The serving function runs the lock-step hop loop
(``compact=None``); batches are padded to power-of-two buckets (rounded to
the data-axis size), the padding given the empty range (1, 0).  With
``visited_adaptive=True`` the batch's hop histogram is counted once per data
shard from the gathered hops (the counterpart of the JAX version's
``psum``), accumulated, and re-sizes the hashed visited filter from a
rolling window of 16 waves (``visited_filter_bits_from_hist``).

Distributed building — ``sharded_build_search`` — splits one micro-batch's
phase-1 candidate searches over a build mesh: every rank holds its own copy
of the frozen ``DeviceBuildArena`` (``core.snapshot.ShardedBuildArena``;
the ranks apply the same deterministic commits, so the copies stay equal)
and runs the device hop pipeline over its equal slice of the padded batch;
its loop stops when *its* members terminate.  Per-member trajectories are
row-independent, so the all-gathered candidate sets are bitwise those of
the one-device build at any rank count, and the phase-2 edge commit
(``WoWIndex._insert_micro_batch``'s deterministic host reduction) needs no
change to stay rank-count-invariant.  Every rank runs that commit: the
ranks agree only if each passes the same rows in the same micro-batches.

Building at scale across hosts: attribute-range partitioned builders
(``partition_bounds``): hosts own contiguous rank ranges of the attribute
space plus a halo of one top-level window on each side.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..monitoring import span
from .device_search import (
    DeviceIndex,
    SearchResult,
    _default_max_hops,
    _drive_chunked,
    _finish_build_search,
    _init_build_state,
    _pow2ceil,
    _prep_build_inputs,
    device_search,
    to_device_index,
    visited_filter_bits,
    visited_filter_bits_from_hist,
)
from .snapshot import Snapshot

BUILD_AXIS = "build"  # default mesh axis name for sharded construction


def _pack(ids, dists, dc, hops) -> np.ndarray:
    """One int32 [rows, 2k + 2] buffer of a search's four results (the
    distances as their f32 bits), so a gather is one collective."""
    return np.concatenate([
        np.asarray(ids, np.int32),
        np.ascontiguousarray(dists, np.float32).view(np.int32),
        np.asarray(dc, np.int32)[:, None],
        np.asarray(hops, np.int32)[:, None],
    ], axis=1)


def _unpack(buf: np.ndarray, k: int):
    return (buf[:, :k], np.ascontiguousarray(buf[:, k:2 * k]).view(np.float32),
            buf[:, 2 * k], buf[:, 2 * k + 1])


def sharded_build_search(
    mesh,
    di: DeviceIndex,
    targets: np.ndarray,
    ranges: np.ndarray,
    eps: np.ndarray,
    l_lo: int,
    l_hi: int,
    seed_ids: np.ndarray | None,
    seed_d: np.ndarray | None,
    *,
    width: int,
    m: int,
    o: int,
    metric: str = "l2",
    seed_width: int | None = None,
    deleted: set[int] | None = None,
    backend: str = "auto",
    visited: str = "hash",
    visited_bits: int | None = None,
    visited_fp: float = 0.02,
    visited_hashes: int = 2,
    merge: str = "auto",
    max_hops: int | None = None,
    axis: str = BUILD_AXIS,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rank-parallel twin of ``device_search.build_search``: one
    micro-batch's phase-1 candidate search, its members split over
    ``mesh``'s ``axis``.  Every rank of the mesh calls it with the same
    arguments.

    The host prep is ``build_search``'s, with the batch padded to a
    multiple of the shard count; rank r searches rows ``[r*s, (r+1)*s)``
    of the padded batch (``s = Bp / shards``) against its own arena,
    through ``build_search``'s chunked compaction driver, so its loop
    stops when its own members terminate (the JAX version's per-shard
    ``while_loop``).  The four result arrays are all-gathered in rank
    order, and the result contract is ``build_search``'s: host ``(res_i,
    res_d, dc, hops)`` with deleted ids masked to -1, bitwise the
    one-device search at every shard count.  The gather is the span
    ``repro_torch.build.gather``."""
    prep = _prep_build_inputs(
        di, targets, ranges, eps, l_lo, l_hi, seed_ids, seed_d,
        width=width, m=m, o=o, metric=metric, seed_width=seed_width,
        backend=backend, visited=visited, visited_bits=visited_bits,
        visited_fp=visited_fp, visited_hashes=visited_hashes, merge=merge,
        max_hops=max_hops, multiple=int(mesh.shape[axis]),
    )
    Bp = prep.args[0].shape[0]
    s = Bp // int(mesh.shape[axis])
    lo = mesh.coord(axis) * s
    args = tuple(a[lo:lo + s] for a in prep.args)
    W = prep.cfg.k
    b_r = min(max(prep.B - lo, 0), s)  # real members of this slice
    st = _init_build_state(prep.di, *args, prep.cfg)
    # build_search's default chunk schedule
    out = _drive_chunked(prep.di, st, prep.cfg, (8, 8), b_r, 1)
    if b_r < s:  # pad the slice back to s rows for the gather
        pad = s - b_r
        out = (
            np.concatenate([out[0], np.full((pad, W), -1, np.int32)]),
            np.concatenate([out[1], np.full((pad, W), np.inf, np.float32)]),
            np.concatenate([out[2], np.zeros(pad, np.int32)]),
            np.concatenate([out[3], np.zeros(pad, np.int32)]),
        )
    with span("repro_torch.build.gather"):
        parts = mesh.all_gather(_pack(*out))
    return _finish_build_search(*_unpack(np.concatenate(parts), W), prep.B,
                                deleted)


def make_serving_fn(
    mesh,
    snap: Snapshot,
    k: int = 10,
    width: int = 64,
    data_axis: str = "data",
    backend: str = "auto",
    pipeline: str = "fused",
    visited: str = "bitmap",
    visited_bits: int | None = None,
    pad_batch: bool = True,
    visited_adaptive: bool = False,
    max_hops: int | None = None,
    vec_dtype: str = "f32",
):
    """Query-sharded serving function over a ``(data, model)`` rank mesh
    (``repro_torch.parallel.serving_mesh``).  Every rank of the mesh
    calls it, and then every call of the returned function, with the same
    arguments.

    Returns ``fn(queries, ranges) -> SearchResult`` (host arrays, the
    global result on every rank).  With ``pad_batch`` (default) a batch is
    padded to the next power-of-two bucket divisible by the data-axis size
    (padding rows carry the empty range (1, 0): inactive, 0 hops); each
    data shard searches its equal slice with the lock-step loop.
    ``max_hops`` caps the global hop budget below the width-derived
    default (best-so-far beams, a bounded wave).

    With ``visited_adaptive=True`` every call also counts the batch's hop
    histogram once per data shard, the padding taken off bin 0, and adds
    it to ``fn.state["hist"]``; with ``visited="hash"`` later calls re-size
    the visited filter from the last 16 waves' histograms
    (``visited_filter_bits_from_hist``; the worst-case sizing covers the
    cold start).  ``fn.state["bits"]`` is the current size,
    ``fn.device_index`` the rank's ``DeviceIndex``."""
    nd = int(mesh.shape[data_axis])
    W = max(width, k)
    # hops <= max_hops: the histogram's last bin
    H = int(max_hops) if max_hops is not None else _default_max_hops(W)
    # scalars taken eagerly: the closure must not keep the whole host
    # snapshot alive next to the device copy
    m, o = snap.m, snap.o
    metric = "l2" if snap.metric == "l2" else "cosine"
    if visited == "hash":
        bits0 = (int(visited_bits) if visited_bits is not None
                 else visited_filter_bits(W, m, H))
        bits0 = _pow2ceil(max(bits0, 1024))
    else:
        bits0 = None  # bitmap mode: nothing to adapt
    di = to_device_index(snap, vec_dtype=vec_dtype, device=mesh.device)
    # one rank per data group gives the gathered result (the others of its
    # group computed the same slice)
    others = [a for a in mesh.axes if a != data_axis]
    picks = [r for r in range(mesh.size)
             if all(mesh.coord(a, r) == 0 for a in others)]
    picks.sort(key=lambda r: mesh.coord(data_axis, r))
    state = {"hist": np.zeros(H + 1, np.int64), "bits": bits0, "calls": 0}
    # rolling per-wave histograms for the measured sizing (the 16-wave
    # window of the serve engine and RagPipeline)
    recent: deque = deque(maxlen=16)

    def serve(queries: np.ndarray, ranges: np.ndarray) -> SearchResult:
        queries = np.asarray(queries, np.float32)
        ranges = np.asarray(ranges, np.float32)
        B = queries.shape[0]
        Bp = B
        if pad_batch:
            Bp = max(_pow2ceil(B), nd)
            if Bp % nd:  # non-pow2 data axis: a multiple instead
                Bp = -(-B // nd) * nd
        elif B % nd:
            raise ValueError(f"batch {B} does not divide over {nd} data "
                             f"shards (pad_batch=False)")
        if Bp != B:  # padding rows carry an empty range -> inactive
            queries = np.concatenate(
                [queries, np.zeros((Bp - B, queries.shape[1]), np.float32)])
            ranges = np.concatenate(
                [ranges,
                 np.tile(np.asarray([[1.0, 0.0]], np.float32), (Bp - B, 1))])
        s = Bp // nd
        lo = mesh.coord(data_axis) * s
        res = device_search(
            di, queries[lo:lo + s], ranges[lo:lo + s], k=k, width=width,
            m=m, o=o, metric=metric, max_hops=max_hops, backend=backend,
            pipeline=pipeline, visited=visited, visited_bits=state["bits"],
        )
        parts = mesh.all_gather(_pack(*res))
        ids, dists, dc, hops = _unpack(
            np.concatenate([parts[r] for r in picks]), k)
        if visited_adaptive:
            hist = np.bincount(np.clip(hops, 0, H),
                               minlength=H + 1).astype(np.int64)
            hist[0] -= Bp - B  # padded rows are inactive: exactly 0 hops
            state["hist"] += hist
            recent.append(hist)
            if visited == "hash":
                state["bits"] = visited_filter_bits_from_hist(
                    np.sum(recent, axis=0), m)
        state["calls"] += 1
        return SearchResult(ids=ids[:B], dists=dists[:B], dc=dc[:B],
                            hops=hops[:B])

    serve.device_index = di  # keep alive / reusable
    serve.state = state  # hop histogram + current visited-filter sizing
    return serve


def partition_bounds(
    attrs_sorted: np.ndarray, num_parts: int, halo: int
) -> list[tuple[int, int, int, int]]:
    """Attribute-range partition assignment for parallel building.

    Returns per-part (own_lo, own_hi, halo_lo, halo_hi) rank bounds
    (inclusive-exclusive own range; halo extends each side by ``halo``).
    """
    n = len(attrs_sorted)
    out = []
    per = int(np.ceil(n / num_parts))
    for p in range(num_parts):
        lo = p * per
        hi = min(n, lo + per)
        if lo >= hi:
            break
        out.append((lo, hi, max(0, lo - halo), min(n, hi + halo)))
    return out
