"""Dispatch wrappers: the CUDA kernel for CUDA tensors, the plain torch
version for CPU tensors.

Policy (``backend=``):
  * ``"auto"`` — by tensor device: a CUDA tensor gets the kernel, a CPU
    tensor the plain version;
  * ``"cuda"`` — force the kernel; a CPU tensor raises;
  * ``"ref"`` — force the plain version (any device).

On a CUDA tensor the wrapper launches the kernel or raises; nothing falls
back to the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref as _ref

BACKENDS = ("auto", "cuda", "ref")


def _use_kernel(backend: str, t: torch.Tensor) -> bool:
    if backend == "ref":
        return False
    if backend == "auto":
        return t.is_cuda
    if backend == "cuda":
        if not t.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f"{t.device}")
        return True
    raise ValueError(f"unknown backend {backend!r}; registered: {BACKENDS}")


def batched_dot(vecs, queries, backend: str = "auto"):
    """out[b, k] = <vecs[b, k], queries[b]> over already-gathered rows (the
    reference hop pipeline's distance stage)."""
    if _use_kernel(backend, vecs):
        from .distance import batched_dot as kern

        return kern(vecs.float(), queries.float())
    return _ref.batched_dot_ref(vecs, queries)


def l2_distance(vecs, queries, sq_norms, backend: str = "auto"):
    if _use_kernel(backend, vecs):
        from .distance import l2_distance as kern

        return kern(vecs.float(), queries.float(), sq_norms)
    return _ref.l2_distance_ref(vecs, queries, sq_norms)


def gather_dot(table, ids, queries, backend: str = "auto"):
    if _use_kernel(backend, table):
        from .gather_distance import gather_dot as kern

        return kern(table, ids.long(), queries.float())
    return _ref.gather_dot_ref(table, ids, queries)


def gather_norm_dot(table, ids, queries, scales=None, backend: str = "auto"):
    """Fused candidate gather -> (dots, sq-norms); the serving hot path.

    ``table`` may be f32, bf16, or int8 (``scales`` = per-row f32 scales,
    required for int8); dequant happens inside the kernel / the plain
    gather — callers never dequantize the slab themselves."""
    if _use_kernel(backend, table):
        from .gather_distance import gather_norm_dot as kern

        return kern(table, ids, queries, scales=scales)
    return _ref.gather_norm_dot_ref(table, ids, queries, scales=scales)


def flash_attention(q, k, v, causal: bool = True, window=None,
                    q_offset: int = 0, backend: str = "auto",
                    block_q: int | None = None):
    """Causal GQA attention, q [B, Tq, Hq, D], k/v [B, Tk, Hkv, D].

    The plain version evaluates query rows in blocks of ``block_q`` (by
    default ``TUNING.attn_block_q`` once Tq reaches
    ``TUNING.attn_blocked_min_t``, as the JAX wrapper does); the kernel
    ignores ``block_q``."""
    if _use_kernel(backend, q):
        from .flash_attention import flash_attention as kern

        return kern(q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=causal, window=window, q_offset=q_offset)
    if block_q is None:
        from ..models.tuning import TUNING

        if q.shape[1] >= TUNING.attn_blocked_min_t:
            block_q = TUNING.attn_block_q
    return _ref.mha_ref(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, block_q=block_q)


def wkv6(r, k, v, w, u, state=None, backend: str = "auto"):
    """The RWKV-6 recurrence over r/k/v/w [B, H, T, N] -> (y in r's type,
    final state f32).  The plain version is the step recurrence
    ``wkv6_ref``, as in the JAX wrapper (the model's own ``backend="ref"``
    branch calls ``wkv6_chunked`` instead)."""
    if _use_kernel(backend, r):
        from .rwkv6 import wkv6 as kern

        return kern(r.contiguous(), k.contiguous(), v.contiguous(),
                    w.float().contiguous(), u.float().contiguous(),
                    None if state is None else state.float().contiguous())
    return _ref.wkv6_ref(r, k, v, w, u, state=state)


def mamba_scan(A, dt, Bm, Cm, x, h0, backend: str = "auto", chunk: int = 64):
    """The Mamba-1 selective scan -> (y [B, T, di] f32, h_T [B, di, N] f32).
    The plain version is the port's own step scan ``mamba_scan_ref`` (the
    JAX wrapper reaches into its model layer for ``_ssm_scan``); ``chunk``
    only sets the JAX scan's checkpoint boundaries, and neither version
    needs it."""
    if _use_kernel(backend, x):
        from .mamba_scan import mamba_scan as kern

        return kern(*(a.float().contiguous() for a in (A, dt, Bm, Cm, x, h0)))
    return _ref.mamba_scan_ref(A, dt, Bm, Cm, x, h0, chunk=chunk)


def merge_src_indices(pos_a, pos_b, W: int, K: int, method: str = "auto"):
    """Source-index writeback of the counting merge (``_merge_sorted``).

    Given the merged output position of every result entry (``pos_a``
    [B, W]) and new entry (``pos_b`` [B, K]) — a bijection onto
    0..W+K-1 with slots >= W dropped — produce ``src`` [B, W] int64 where
    ``src[b, p]`` is the concatenated-source index (0..W-1 = result row,
    W..W+K-1 = new row) that lands at output slot ``p``.

      * ``"scatter"`` — one scatter of source indices over the full
        W+K positions, then the first W slots;
      * ``"onehot"`` — position-equality one-hots contracted against the
        source-index iota (exact: one hit per output column, indices far
        below 2^24);
      * ``"sort"`` — invert the position permutation with one packed
        single-key sort: ``pos * (W+K) + src`` sorts into output order, and
        the low digits of the first W keys ARE the source indices;
      * ``"auto"`` — ``"sort"`` on every device.
    """
    if method == "auto":
        method = "sort"
    B = pos_a.shape[0]
    WK = W + K
    dev = pos_a.device
    if method == "sort":
        pos = torch.cat([pos_a, pos_b], dim=1).long()
        key = pos * WK + torch.arange(WK, device=dev)[None, :]
        key = torch.sort(key, dim=1, stable=True).values[:, :W]
        return key % WK
    if method == "scatter":
        pos = torch.cat([pos_a, pos_b], dim=1).long()
        src = torch.empty((B, WK), dtype=torch.int64, device=dev)
        src.scatter_(1, pos, torch.arange(WK, device=dev).expand(B, WK))
        return src[:, :W]
    if method == "onehot":
        out = torch.arange(W, device=dev)[None, None, :]
        oa = (pos_a[:, :, None] == out).float()  # [B, W, W]
        ob = (pos_b[:, :, None] == out).float()  # [B, K, W]
        srcf = torch.einsum("bsw,s->bw", oa,
                            torch.arange(W, dtype=torch.float32, device=dev))
        srcf = srcf + torch.einsum(
            "bkw,k->bw", ob,
            W + torch.arange(K, dtype=torch.float32, device=dev))
        return srcf.long()
    raise ValueError(f"unknown writeback method {method!r}")


def replicate(tree, mesh):
    """Place every tensor leaf of ``tree`` (tuples, lists, dicts, None) on
    ``mesh.device``, this rank's device.

    The counterpart of the JAX package's ``replicate``, which puts one
    copy of every leaf on each device of the mesh through a replicated
    ``NamedSharding``.  Under SPMD there is no placement across devices:
    each rank holds its own copy of the arena on its own device and
    applies the same deterministic commits to it, so the copies stay
    equal; placing the leaves on the rank's device is all that is left."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(x, mesh) for x in tree)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree


def _host_rows(rows: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host rows -> a tensor of ``like``'s dtype on its device; a bf16
    slab's rows arrive as their uint16 bit pattern."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype == np.uint16:
        t = torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(rows)
    return t.to(device=like.device, dtype=like.dtype)


def arena_scatter(dst: torch.Tensor, idx, rows) -> torch.Tensor:
    """Delta update of a device arena, in place: ``dst[idx] = rows`` for
    host arrays of the changed rows only (distinct ``idx``), never a
    re-upload.  Returns ``dst``.  (The JAX version pads the index batch to
    a pow2 bucket by repeating row 0 to bound its compiles; torch needs no
    such padding, and duplicate targets would make the write order
    nondeterministic on CUDA.)"""
    idx = np.asarray(idx, np.int64)
    if idx.shape[0] == 0:
        return dst
    it = torch.from_numpy(idx).to(dst.device)
    dst.index_copy_(0, it, _host_rows(rows, dst))
    return dst


def arena_scatter_layers(dst: torch.Tensor, lidx, vidx, rows) -> torch.Tensor:
    """``dst[lidx, vidx] = rows`` for a [L, cap, m] arena, in place (see
    ``arena_scatter``; the (layer, vertex) pairs are distinct)."""
    lidx = np.asarray(lidx, np.int64)
    if lidx.shape[0] == 0:
        return dst
    lt = torch.from_numpy(lidx).to(dst.device)
    vt = torch.from_numpy(np.asarray(vidx, np.int64)).to(dst.device)
    dst[lt, vt] = _host_rows(rows, dst)
    return dst
