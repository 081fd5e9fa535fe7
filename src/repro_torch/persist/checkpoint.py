"""Versioned checkpoints of a ``WoWIndex`` (full + incremental/delta), the
port of ``repro.persist.checkpoint``: the same directory layout, sections
and manifest, so either package loads what the other saved, with equal
``state_digest``.

A checkpoint directory serializes everything a bitwise restore needs:

* vector/attr/norm slabs (``store`` prefixes ``[:n]``),
* the layered graph (stacked adjacency + counts prefixes),
* WBT state (``val[:wn]`` — which IS the insertion order, so replaying
  ``wbt.insert`` per value reconstructs ``left``, ``right``, ``size``
  and ``root`` bit for bit),
* tombstones (``deleted``; the dead-value list and live counts are
  reconstructed deterministically from attrs + tombstones),
* RNG/mutation stamps (``np.random.Generator`` bit-generator state as
  JSON, ``mutations``, ``graph.version``, build stats — so ``describe()``
  and all later stochastic choices round-trip exactly),
* the delta-arena tail is NOT serialized: build arenas/slabs/visited pools
  are derived caches that any backend rebuilds lazily (amortised) and that
  never influence committed results.

Incremental checkpoints ride the index's second dirty-row tracker
(``_ckpt_tracker``, fed by the same ``_commit_deltas`` that feeds
``take_snapshot(prev=)``): a delta saves only the store/WBT tails since the
base checkpoint, the dirty graph rows, and the (small) tombstone/meta
sections — steady-state checkpoints are O(changed rows).  Chains are capped
at ``full_every`` deltas before the next save is forced full.

Atomicity: sections + manifest land in ``<name>.tmp``, the tmp dir is
fsynced, then ``os.replace``d into place and the parent fsynced — readers
see either the old set of checkpoints or the new one, never a torn write.
Retention keeps the two newest checkpoints plus their delta-chain bases.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .faultfs import OsIO
from .format import (
    CorruptError,
    canonical_json,
    read_manifest,
    read_section,
    write_manifest,
    write_section,
)

CKPT_SUBDIR = "checkpoints"
CKPT_PREFIX = "ckpt-"


def checkpoint_dir(root: str) -> str:
    return os.path.join(root, CKPT_SUBDIR)


def list_checkpoints(root: str) -> list[tuple[int, str]]:
    """(seq, path) pairs of finalized checkpoints, seq-ascending."""
    d = checkpoint_dir(root)
    out = []
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith(CKPT_PREFIX) and not name.endswith(".tmp"):
                try:
                    seq = int(name[len(CKPT_PREFIX):])
                except ValueError:
                    continue
                out.append((seq, os.path.join(d, name)))
    out.sort()
    return out


def _index_meta(index) -> dict:
    p = index.params
    bs = index.build_stats
    return {
        "n": int(index.store.n),
        "dim": int(index.store.dim),
        "m": int(p.m),
        "ef_construction": int(p.ef_construction),
        "o": int(p.o),
        "metric": p.metric,
        "seed": int(p.seed),
        "store_cap": int(index.store.capacity),
        "graph_cap": int(index.graph.capacity),
        "wbt_cap": int(index.wbt._cap),
        "wn": int(index.wbt.n),
        "num_layers": int(index.graph.num_layers),
        "vec_dtype": getattr(index, "vec_dtype", "f32"),
        "graph_version": int(index.graph.version),
        "mutations": int(index.mutations),
        "lsn": int(getattr(index, "_applied_lsn", 0)),
        "epoch": int(getattr(index, "_epoch", 0)),
        "compact_dead_done": int(getattr(index, "_compact_dead_done", 0)),
        "build_stats": {
            "dc": int(bs.dc),
            "searches": int(bs.searches),
            "searches_skipped": int(bs.searches_skipped),
            "prunes": int(bs.prunes),
        },
        "rng_state": _jsonable(index._rng.bit_generator.state),
    }


def _jsonable(obj):
    """bit_generator.state can contain numpy scalars; normalize to JSON."""
    return json.loads(json.dumps(obj, default=int))


# ---------------------------------------------------------------------- save
def save(index, root: str, io: OsIO | None = None, incremental: bool = True,
         full_every: int = 8) -> str:
    """Write a checkpoint of ``index`` under ``<root>/checkpoints/``.

    Incremental when possible (see module docstring); falls back to a full
    checkpoint whenever the dirty tracker cannot vouch for the interval
    since the newest checkpoint.  After a successful save: the tracker is
    reset, retention keeps the two newest checkpoints (plus delta bases),
    and — when the index has a WAL attached — the log is rotated and
    segments covered by every retained checkpoint are pruned.

    Returns the new checkpoint's path.
    """
    io = io or OsIO()
    # the checkpoint boundary is also a compaction-cadence boundary
    index._maybe_auto_compact()
    io.mkdir(checkpoint_dir(root))
    existing = list_checkpoints(root)
    seq = (existing[-1][0] + 1) if existing else 1

    base = None  # (manifest, path)
    if incremental and existing:
        try:
            bman = read_manifest(existing[-1][1])
        except CorruptError:
            bman = None
        tr = index._ckpt_tracker
        if (
            bman is not None
            and not tr["all"]
            and bman["meta"]["mutations"] == tr["stamp"]
            and bman.get("depth", 0) + 1 < full_every
            and bman["meta"]["n"] <= index.store.n
            and bman["meta"]["num_layers"] <= index.graph.num_layers
            and bman["meta"]["wn"] <= index.wbt.n
            and bman["meta"]["m"] == index.params.m
            and bman["meta"].get("vec_dtype", "f32")
            == getattr(index, "vec_dtype", "f32")
        ):
            base = (bman, existing[-1][1])

    name = f"{CKPT_PREFIX}{seq:08d}"
    final = os.path.join(checkpoint_dir(root), name)
    tmp = final + ".tmp"
    io.remove(tmp)
    io.mkdir(tmp)
    sections: dict[str, dict] = {}
    meta = _index_meta(index)
    n = meta["n"]
    L = meta["num_layers"]
    st, g = index.store, index.graph

    def put(sname: str, arr: np.ndarray) -> None:
        sections[sname] = write_section(io, tmp, sname, arr)

    # quantized serving slabs (format v2): the storage-dtype vector slab +
    # per-row int8 scales ride alongside the f32 oracle sections, so the
    # serve-from-checkpoint cold start maps them directly instead of
    # re-quantizing n*d floats.  Per-row quantization makes delta tails
    # bitwise identical to slices of a full-slab quantization.  A bf16
    # slab is its uint16 bit pattern already (``quantize_rows``).
    vec_dtype = getattr(index, "vec_dtype", "f32")

    def put_quantized(lo: int, hi: int, suffix: str = "") -> None:
        if vec_dtype == "f32":
            return
        from ..core.store import quantize_rows

        slab, scales = quantize_rows(st.vectors[lo:hi], vec_dtype)
        put(f"q_vectors{suffix}", slab)
        if scales is not None:
            put(f"q_scales{suffix}", scales)

    if base is None:
        put("vectors", st.vectors[:n])
        put("attrs", st.attrs[:n])
        put("sq_norms", st.sq_norms[:n])
        put_quantized(0, n)
        put("neighbors", np.stack([lay[:n] for lay in g.layers])
            if n else np.zeros((L, 0, g.m), np.int32))
        put("counts", np.stack([c[:n] for c in g.counts])
            if n else np.zeros((L, 0), np.int32))
        put("wbt_vals", index.wbt.val[: index.wbt.n])
        manifest = {"kind": "full", "seq": seq, "base": None, "depth": 0}
    else:
        bman, _ = base
        bn = bman["meta"]["n"]
        bL = bman["meta"]["num_layers"]
        bwn = bman["meta"]["wn"]
        put("vectors_tail", st.vectors[bn:n])
        put("attrs_tail", st.attrs[bn:n])
        put("sq_norms_tail", st.sq_norms[bn:n])
        put_quantized(bn, n, suffix="_tail")
        put("wbt_vals_tail", index.wbt.val[bwn: index.wbt.n])
        dirty = index._ckpt_tracker["dirty"]
        for l in range(L):
            if l < bL:
                parts = dirty.get(l, ())
                rows = (
                    np.unique(np.concatenate([np.asarray(p) for p in parts]))
                    if parts else np.empty(0, np.int64)
                )
                rows = rows[rows < bn]
                put(f"dirty_rows_{l}", rows)
                put(f"dirty_nbr_{l}", g.layers[l][rows])
                put(f"dirty_cnt_{l}", g.counts[l][rows])
                put(f"tail_nbr_{l}", g.layers[l][bn:n])
                put(f"tail_cnt_{l}", g.counts[l][bn:n])
            else:
                put(f"full_nbr_{l}", g.layers[l][:n])
                put(f"full_cnt_{l}", g.counts[l][:n])
        manifest = {
            "kind": "delta",
            "seq": seq,
            "base": bman["seq"],
            "depth": bman.get("depth", 0) + 1,
        }

    deleted = np.fromiter(sorted(index.deleted), dtype=np.int64,
                          count=len(index.deleted))
    put("deleted", deleted)
    # dead values are stored f32 (format v2): attrs are canonicalized to
    # exactly-f32-representable values at ingest, so f32 is lossless here —
    # a f64 section would let a value that differs under f64<->f32 round
    # through recovery and silently resurrect in ``selectivity``.  v1
    # checkpoints have no section; readers reconstruct from attrs+deleted.
    put("dead_vals", np.asarray(index._dead_vals, np.float32))
    manifest["meta"] = meta
    manifest["sections"] = sections
    write_manifest(io, tmp, manifest)
    io.fsync_dir(tmp)
    io.replace(tmp, final)
    io.fsync_dir(checkpoint_dir(root))

    # checkpoint durable: reset the dirty tracker to this new base
    index._ckpt_tracker = {"stamp": index.mutations, "all": False, "dirty": {}}

    _retain(root, io, keep=2)
    wal = getattr(index, "_wal", None)
    if wal is not None:
        wal.rotate()
        kept = _retained_lsns(root)
        if kept:
            wal.prune(min(kept))
    return final


def _chain_seqs(root: str, seq: int) -> set[int]:
    """The checkpoint's full delta chain (itself + transitive bases)."""
    by_seq = dict(list_checkpoints(root))
    out = set()
    cur: int | None = seq
    while cur is not None and cur in by_seq and cur not in out:
        out.add(cur)
        try:
            cur = read_manifest(by_seq[cur]).get("base")
        except CorruptError:
            break
    return out

def _retain(root: str, io: OsIO, keep: int = 2) -> None:
    ckpts = list_checkpoints(root)
    keep_seqs: set[int] = set()
    for seq, _ in ckpts[-keep:]:
        keep_seqs |= _chain_seqs(root, seq)
    removed = False
    for seq, path in ckpts:
        if seq not in keep_seqs:
            io.remove(path)
            removed = True
    if removed:
        io.fsync_dir(checkpoint_dir(root))


def _retained_lsns(root: str) -> list[int]:
    out = []
    for _, path in list_checkpoints(root):
        try:
            out.append(read_manifest(path)["meta"]["lsn"])
        except CorruptError:
            continue
    return out


# ---------------------------------------------------------------------- load
def _load_state(root: str, seq: int, mmap: bool = False) -> dict:
    """Compose the checkpoint chain ending at ``seq`` into host arrays.

    With ``mmap`` (full checkpoints only) the big slabs are memory mapped
    after CRC validation — the serve-from-checkpoint cold start.  A bf16
    ``q_vectors`` slab stays its uint16 bit pattern, the port's in-memory
    form of a bf16 slab.
    """
    by_seq = dict(list_checkpoints(root))
    if seq not in by_seq:
        raise CorruptError(f"checkpoint {seq} missing (broken delta chain)")
    path = by_seq[seq]
    man = read_manifest(path)
    meta = man["meta"]
    sec = man["sections"]
    n, L, m = meta["n"], meta["num_layers"], meta["m"]

    def rd(name: str, use_mmap: bool = False) -> np.ndarray:
        if name not in sec:
            raise CorruptError(f"checkpoint {seq}: missing section {name!r}")
        return read_section(path, name, sec[name], mmap=use_mmap)

    if man["kind"] == "full":
        state = {
            "vectors": rd("vectors", mmap),
            "attrs": rd("attrs"),
            "sq_norms": rd("sq_norms", mmap),
            "neighbors": rd("neighbors", mmap),
            "counts": rd("counts"),
            "wbt_vals": rd("wbt_vals"),
        }
        if "q_vectors" in sec:
            state["q_vectors"] = rd("q_vectors", mmap)
        if "q_scales" in sec:
            state["q_scales"] = rd("q_scales", mmap)
    else:
        base = _load_state(root, man["base"], mmap=False)
        bn = base["meta"]["n"]
        bL = base["meta"]["num_layers"]
        if bn != base["vectors"].shape[0]:
            raise CorruptError(f"checkpoint {seq}: base shape mismatch")
        state = {
            "vectors": np.concatenate([base["vectors"], rd("vectors_tail")]),
            "attrs": np.concatenate([base["attrs"], rd("attrs_tail")]),
            "sq_norms": np.concatenate(
                [base["sq_norms"], rd("sq_norms_tail")]
            ),
            "wbt_vals": np.concatenate(
                [base["wbt_vals"], rd("wbt_vals_tail")]
            ),
        }
        if "q_vectors_tail" in sec:
            state["q_vectors"] = np.concatenate(
                [np.asarray(base["q_vectors"]),
                 rd("q_vectors_tail")]
            )
        if "q_scales_tail" in sec:
            state["q_scales"] = np.concatenate(
                [np.asarray(base["q_scales"]), rd("q_scales_tail")]
            )
        neighbors = np.empty((L, n, m), np.int32)
        counts = np.empty((L, n), np.int32)
        for l in range(L):
            if l < bL:
                neighbors[l, :bn] = base["neighbors"][l]
                counts[l, :bn] = base["counts"][l]
                neighbors[l, bn:] = rd(f"tail_nbr_{l}")
                counts[l, bn:] = rd(f"tail_cnt_{l}")
                rows = rd(f"dirty_rows_{l}")
                if rows.size:
                    neighbors[l, rows] = rd(f"dirty_nbr_{l}")
                    counts[l, rows] = rd(f"dirty_cnt_{l}")
            else:
                neighbors[l] = rd(f"full_nbr_{l}")
                counts[l] = rd(f"full_cnt_{l}")
        state["neighbors"] = neighbors
        state["counts"] = counts
    state["deleted"] = rd("deleted")
    # v1 checkpoints predate the explicit f32 dead-value section; readers
    # migrate by reconstructing from attrs + tombstones (see materialize)
    state["dead_vals"] = rd("dead_vals") if "dead_vals" in sec else None
    state["meta"] = meta
    if state["vectors"].shape != (n, meta["dim"]) or state[
        "wbt_vals"
    ].shape != (meta["wn"],):
        raise CorruptError(f"checkpoint {seq}: composed shape mismatch")
    return state


def load_state(root: str, mmap: bool = False) -> dict:
    """Compose the newest *valid* checkpoint chain; a corrupt newest
    checkpoint falls back to the next older one (clean refusal only when
    none validates)."""
    ckpts = list_checkpoints(root)
    if not ckpts:
        raise CorruptError(f"no checkpoints under {checkpoint_dir(root)}")
    err: Exception | None = None
    for seq, _ in reversed(ckpts):
        try:
            return _load_state(root, seq, mmap=mmap)
        except CorruptError as e:
            err = e
    raise CorruptError(f"no valid checkpoint under {root}: {err}")


def materialize(state: dict, device=None):
    """Rebuild a live ``WoWIndex`` from composed checkpoint state, bitwise
    identical (over all meaningful prefixes) to the index that saved it.
    ``device`` is the index's build device (``WoWIndex(device=)``: None =
    the CUDA card, used by the "ops"/"device" insert backends only)."""
    from ..core.graph import PAD, LayeredGraph
    from ..core.index import WoWIndex
    from ..core.store import VectorStore
    from ..core.wbt import WBT

    meta = state["meta"]
    n, L, m = meta["n"], meta["num_layers"], meta["m"]
    index = WoWIndex(
        dim=meta["dim"], m=m, ef_construction=meta["ef_construction"],
        o=meta["o"], metric=meta["metric"], seed=meta["seed"],
        vec_dtype=meta.get("vec_dtype", "f32"), device=device,
    )
    st = VectorStore(meta["dim"], metric=meta["metric"],
                     capacity=meta["store_cap"])
    st.vectors[:n] = state["vectors"]
    st.attrs[:n] = state["attrs"]
    st.sq_norms[:n] = state["sq_norms"]
    st.n = n
    st.attrs_list = st.attrs[:n].tolist()
    index.store = st

    g = LayeredGraph(m, capacity=meta["graph_cap"])
    for _ in range(L - 1):
        g.add_layer()
    for l in range(L):
        g.layers[l][:n] = state["neighbors"][l]
        g.layers[l][n:] = PAD
        g.counts[l][:n] = state["counts"][l]
        g.counts[l][n:] = 0
    g.version = meta["graph_version"]
    index.graph = g

    wbt = WBT(capacity=meta["wbt_cap"])
    for v in state["wbt_vals"].tolist():
        wbt.insert(v)
    index.wbt = wbt

    index.deleted = set(state["deleted"].tolist())
    # value_map / live counts / dead values are fully determined by
    # (attrs, deleted): vids ascend in insertion order, so id-order
    # reconstruction reproduces the live dict contents exactly
    value_map: dict[float, list[int]] = {}
    live: dict[float, int] = {}
    for vid, val in enumerate(st.attrs_list):
        value_map.setdefault(val, []).append(vid)
        live[val] = live.get(val, 0) + (0 if vid in index.deleted else 1)
    index.value_map = value_map
    index._live_counts = live
    if state.get("dead_vals") is not None:
        # v2: the f32 section is authoritative — attrs are f32-canonical
        # at ingest, so float(np.float32) round-trips exactly onto the
        # host f64 order keys (no resurrection after recovery)
        index._dead_vals = [float(v) for v in state["dead_vals"]]
    else:  # v1 migrate-on-read: reconstruct from attrs + tombstones
        index._dead_vals = sorted(v for v, c in live.items() if c == 0)

    index.mutations = meta["mutations"]
    bs = meta["build_stats"]
    index.build_stats.dc = bs["dc"]
    index.build_stats.searches = bs["searches"]
    index.build_stats.searches_skipped = bs["searches_skipped"]
    index.build_stats.prunes = bs["prunes"]
    index._rng.bit_generator.state = meta["rng_state"]
    index._compact_dead_done = meta["compact_dead_done"]
    index._applied_lsn = meta["lsn"]
    # fencing epoch (0 on pre-replication checkpoints); like _applied_lsn
    # it is positional metadata, deliberately outside the state digest
    index._epoch = meta.get("epoch", 0)
    # a just-loaded index IS the newest checkpoint's state: the ckpt
    # tracker can vouch for deltas from here on
    index._ckpt_tracker = {"stamp": index.mutations, "all": False,
                           "dirty": {}}
    index._snap_tracker = {"stamp": -1, "all": True, "dirty": {}}
    return index


def load(root: str, device=None):
    """``materialize(load_state(root), device)``: restore without WAL
    replay."""
    return materialize(load_state(root), device=device)


# -------------------------------------------------------- equality / digests
def index_arrays(index) -> list[tuple[str, np.ndarray]]:
    """Canonical (name, array) list covering every meaningful prefix of
    index state — the comparison basis for round-trip and fault-sweep
    bitwise-equality assertions."""
    n = index.store.n
    wn = index.wbt.n
    out = [
        ("vectors", index.store.vectors[:n]),
        ("attrs", index.store.attrs[:n]),
        ("sq_norms", index.store.sq_norms[:n]),
        ("wbt_val", index.wbt.val[:wn]),
        ("wbt_left", index.wbt.left[:wn]),
        ("wbt_right", index.wbt.right[:wn]),
        ("wbt_size", index.wbt.size[:wn]),
        ("deleted", np.fromiter(sorted(index.deleted), np.int64,
                                count=len(index.deleted))),
        # f32, matching the checkpoint section: attrs are f32-canonical at
        # ingest, so this is lossless — and a f64 basis here would mask a
        # writer that narrows dead values on the way to disk
        ("dead_vals", np.asarray(index._dead_vals, np.float32)),
    ]
    for l in range(index.graph.num_layers):
        out.append((f"nbr_{l}", index.graph.layers[l][:n]))
        out.append((f"cnt_{l}", index.graph.counts[l][:n]))
    return out


def index_scalars(index) -> dict:
    bs = index.build_stats
    return {
        "n": int(index.store.n),
        "wn": int(index.wbt.n),
        "wbt_root": int(index.wbt.root),
        "num_layers": int(index.graph.num_layers),
        "graph_version": int(index.graph.version),
        "mutations": int(index.mutations),
        "compact_dead_done": int(getattr(index, "_compact_dead_done", 0)),
        "build_stats": [int(bs.dc), int(bs.searches),
                        int(bs.searches_skipped), int(bs.prunes)],
        "params": [index.params.m, index.params.ef_construction,
                   index.params.o, index.params.metric, index.params.seed],
        "rng_state": _jsonable(index._rng.bit_generator.state),
    }


def state_digest(index) -> str:
    """sha256 over the canonical state (arrays + scalars) — two indices
    with equal digests are bitwise-identical over every prefix that can
    ever influence results (``_applied_lsn`` excluded: a WAL-replayed
    index and a never-logged reference are otherwise identical)."""
    h = hashlib.sha256()
    h.update(canonical_json(index_scalars(index)))
    for name, arr in index_arrays(index):
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def assert_index_equal(a, b) -> None:
    """Bitwise equality over the canonical state; raises AssertionError
    naming the first differing field."""
    sa, sb = index_scalars(a), index_scalars(b)
    assert sa == sb, f"scalar state differs: {sa} != {sb}"
    for (name, xa), (_, xb) in zip(index_arrays(a), index_arrays(b)):
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, (
            f"{name}: dtype/shape {xa.dtype}{xa.shape} != {xb.dtype}{xb.shape}"
        )
        assert np.array_equal(xa, xb), f"array {name!r} differs"
    assert a.describe() == b.describe()
