"""Pre-refactor ``device_search`` hop stages — kept as the parity oracle.

The port of ``repro.core.hop_reference``: the original (correct but slow)
implementations of the three hop stages that the fused pipeline in
``device_search`` replaced:

  * ``dedupe_pairwise``   — O(F^2) all-pairs duplicate mask ([B, F, F]
    bool intermediate, F = L*m);
  * ``merge_full_sort``   — a stable full-width ``torch.sort`` over
    [B, W+K] to merge K new candidates into the sorted width-W results;
  * ``eval_materialized`` — a gather of a [B, K, d] candidate tensor
    followed by the ``batched_dot`` kernel (the device-memory round trip
    the fused gather kernel avoids), with the cached per-vertex squared
    norms gathered separately.

``device_search(..., pipeline="reference")`` runs the hop with these
stages; parity tests hold its ids, DC and hop counters against the fused
pipeline.  Not for production serving — every stage here is dominated.

The hashed visited filter (``visited="hash"``) gets the same treatment:
``hash_positions_ref`` / ``hash_mark_dense`` / ``hash_test_dense`` are a
plain-numpy dense-boolean re-statement of the packed double-hashed filter
(one uint8 per *bit*, direct fancy indexing, no word packing) used by the
tests to pin down the packed implementation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import batched_dot

_BIG = 2**30


def dedupe_pairwise(ids_f: torch.Tensor, rank_f: torch.Tensor):
    """All-pairs dedupe: drop an entry if a better-ranked eligible entry
    carries the same id (the host marks it visited first).  Returns the
    (ids, masked ranks) pair in the original flattened order."""
    eq = ids_f[:, :, None] == ids_f[:, None, :]  # [B, F, F]
    better = rank_f[:, None, :] < rank_f[:, :, None]
    dup = (eq & better & (rank_f[:, None, :] < _BIG)).any(dim=2)
    return ids_f, rank_f.masked_fill(dup, _BIG)


def merge_full_sort(res_d, res_i, res_e, dd, new_i, new_e, W: int):
    """Merge K new entries by a stable sort of the full [B, W+K]
    concatenation on distance (result entries stay ahead of new entries on
    equal distances, as ``lax.sort`` keeps them)."""
    cat_d = torch.cat([res_d, dd], dim=1)
    cat_i = torch.cat([res_i, new_i], dim=1)
    cat_e = torch.cat([res_e, new_e], dim=1)
    srt_d, order = torch.sort(cat_d, dim=1, stable=True)
    order = order[:, :W]
    return (srt_d[:, :W], torch.gather(cat_i, 1, order),
            torch.gather(cat_e, 1, order))


def hash_positions_ref(ids: np.ndarray, v_bits: int, nh: int) -> np.ndarray:
    """numpy twin of the device filter's probe positions: ids int[...] ->
    uint32[..., nh] (shared with the host filter)."""
    from .search import hash_positions_np

    return hash_positions_np(ids, v_bits, nh)


def hash_mark_dense(dense: np.ndarray, ids, valid, nh: int) -> np.ndarray:
    """Insert ids [B, K] into a dense uint8 bit array [B, v_bits]."""
    B, v_bits = dense.shape
    pos = hash_positions_ref(ids, v_bits, nh)  # [B, K, nh]
    rows = np.arange(B)[:, None, None]
    out = dense.copy()
    np.maximum.at(out, (np.broadcast_to(rows, pos.shape),
                        pos.astype(np.int64)),
                  np.asarray(valid)[:, :, None].astype(np.uint8))
    return out


def hash_test_dense(dense: np.ndarray, ids, nh: int) -> np.ndarray:
    """Membership of ids [B, ...] in the dense bit array -> bool."""
    B, v_bits = dense.shape
    pos = hash_positions_ref(ids, v_bits, nh).astype(np.int64)
    rows = np.arange(B).reshape((B,) + (1,) * (pos.ndim - 1))
    return dense[rows, pos].min(axis=-1) > 0


def unpack_filter(vstate) -> np.ndarray:
    """Packed filter [B, Vw(+trash)] of uint32 word values (the port's
    int64 words or JAX's uint32) -> dense uint8 bits [B, Vw*32] (the
    trailing trash word is dropped)."""
    if isinstance(vstate, torch.Tensor):
        vstate = vstate.cpu().numpy()
    words = np.asarray(vstate)[:, :-1].astype(np.uint64)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint64)) & 1
    return bits.reshape(words.shape[0], -1).astype(np.uint8)


def eval_materialized(vectors, sq_norms, idc, queries, backend: str):
    """Gather a [B, K, d] candidate tensor, then dot it with the queries
    through ``batched_dot`` (the CUDA kernel for CUDA tensors).  Returns
    (dots, v2) with v2 taken from the cached norm table."""
    vecs = vectors[idc]
    dots = batched_dot(vecs, queries, backend=backend)
    return dots, sq_norms[idc]
