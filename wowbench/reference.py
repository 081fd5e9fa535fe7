"""The plain reference and the comparison that decides ``correct``.

The reference is exact range-filtered k-nearest-neighbour search in
float64 over the raw vectors, attributes, queries and ranges that the
benchmark handed to the program: a brute-force distance matrix in blocks
of queries, rows outside the query's attribute range masked out, the k
smallest kept.  It takes nothing the program made (no index, snapshot or
table) and imports nothing of it.

``judge`` holds the program's replies to it.  Each reply is checked on its
own (ids valid, distinct, inside the range, distances ascending; each
reported distance against the exact distance of the id it names), and the
replies together by their mean recall@k against the exact answers.  The
numbers, each beside its limit:

* ``unanswered`` (limit 0): requests that never got a reply;
* ``bad_replies`` (limit 0): replies that break a per-reply rule above;
* ``dist_gap`` (limit from the configuration): the widest gap between a
  reported distance and the exact one, over ``|q|^2 + |v|^2``, the size of
  the terms the factorised distance subtracts;
* ``recall`` (floor from the configuration): mean recall@k.

``tf32`` rounds a float32 array to TF32 (10 explicit mantissa bits, round
to nearest even), the precision a tensor-core float32 product reads its
inputs at; the control (``wowbench.control``) computes the reference from
such inputs in the program's place and has to come out not correct.
"""
from __future__ import annotations

import numpy as np
import torch


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` (float32) rounded to TF32 precision, as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    lsb = (b >> 13) & 1
    b = ((b + 0xFFF + lsb) >> 13) << 13
    return b.astype(np.uint32).view(np.float32)


def exact_knn(vectors: np.ndarray, attrs: np.ndarray, queries: np.ndarray,
              ranges: np.ndarray, k: int, device="cpu", block: int = 512,
              dtype=torch.float64):
    """Exact range-filtered k-NN -> (ids i64[Q, k], dists f64[Q, k]); -1
    and +inf pad a query whose range holds fewer than k rows.  Distances
    are ``|q|^2 - 2 q.v + |v|^2`` in ``dtype`` over rows with ``lo <= attr
    <= hi``."""
    dev = torch.device(device)
    v = torch.as_tensor(vectors, device=dev).to(dtype)
    a = torch.as_tensor(np.asarray(attrs, np.float64), device=dev)
    v2 = (v * v).sum(1)
    nq = len(queries)
    kk = min(k, v.shape[0])
    ids = np.full((nq, k), -1, np.int64)
    dists = np.full((nq, k), np.inf, np.float64)
    for s in range(0, nq, block):
        q = torch.as_tensor(queries[s:s + block], device=dev).to(dtype)
        r = torch.as_tensor(np.asarray(ranges[s:s + block], np.float64),
                            device=dev)
        d = (q * q).sum(1, keepdim=True) - 2.0 * (q @ v.T) + v2[None, :]
        inside = (a[None, :] >= r[:, :1]) & (a[None, :] <= r[:, 1:])
        d = d.masked_fill(~inside, float("inf")).double()
        top_d, top_i = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        top_i = top_i.masked_fill(torch.isinf(top_d), -1)
        ids[s:s + block, :kk] = top_i.cpu().numpy()
        dists[s:s + block, :kk] = top_d.cpu().numpy()
    return ids, dists


def pair_dists(vectors: np.ndarray, queries: np.ndarray, qidx: np.ndarray,
               ids: np.ndarray, device="cpu", block: int = 4096):
    """Exact f64 ``|q - v|^2`` of each reply slot's id, and the scale
    ``|q|^2 + |v|^2`` -> (dist f64[R, k], scale f64[R, k]); slots whose id
    is outside the table read +inf and 1."""
    dev = torch.device(device)
    n = len(vectors)
    v = torch.as_tensor(vectors, device=dev)
    qs = torch.as_tensor(queries, device=dev)
    out_d = np.full(ids.shape, np.inf, np.float64)
    out_s = np.ones(ids.shape, np.float64)
    for s in range(0, len(ids), block):
        i = torch.as_tensor(ids[s:s + block], device=dev)
        ok = (i >= 0) & (i < n)
        rows = v[i.clamp(0, n - 1)].double()  # [b, k, d]
        q = qs[torch.as_tensor(qidx[s:s + block], device=dev)].double()
        d = ((rows - q[:, None, :]) ** 2).sum(-1)
        sc = (rows * rows).sum(-1) + (q * q).sum(-1, keepdim=True)
        out_d[s:s + block] = d.masked_fill(~ok, float("inf")).cpu().numpy()
        out_s[s:s + block] = sc.masked_fill(~ok, 1.0).cpu().numpy()
    return out_d, out_s


def bad_replies(ids: np.ndarray, dists: np.ndarray, attrs: np.ndarray,
                ranges: np.ndarray) -> np.ndarray:
    """Per reply: True where an id is out of the table or outside the
    query's range, an id repeats, a valid id follows padding, or the
    reported distances of the valid ids do not ascend."""
    n = len(attrs)
    valid = ids >= 0
    inside = ids < n
    a = attrs[np.clip(ids, 0, n - 1)]
    in_range = (a >= ranges[:, :1]) & (a <= ranges[:, 1:])
    bad = (valid & ~(inside & in_range)).any(1)
    bad |= (valid[:, 1:] & ~valid[:, :-1]).any(1)
    srt = np.sort(np.where(valid, ids, -1 - np.arange(ids.shape[1])), 1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    dd = np.where(valid, dists, np.inf)
    with np.errstate(invalid="ignore"):
        bad |= ((dd[:, 1:] < dd[:, :-1]) & valid[:, 1:]).any(1)
        bad |= (valid & ~np.isfinite(dists)).any(1)
    return bad


def recall_at_k(ids: np.ndarray, gold: np.ndarray) -> np.ndarray:
    """Per reply: |found & gold| / |gold| (1 where the range is empty).
    The ids of one reply are distinct, as ``bad_replies`` holds them."""
    hit = (ids[:, :, None] == gold[:, None, :]) & (gold[:, None, :] >= 0)
    found = hit.any(2).sum(1)
    want = (gold >= 0).sum(1)
    return np.where(want > 0, found / np.maximum(want, 1), 1.0)


def judge(vectors, attrs, queries, ranges, qidx, ids, dists, *, k: int,
          limits: dict, unanswered: int = 0, device="cpu",
          recall_mask=None) -> dict:
    """Hold replies against the reference.  ``queries``/``ranges`` are the
    distinct requests; reply ``r`` answered request ``qidx[r]`` with the
    ``k`` ids ``ids[r]`` and distances ``dists[r]`` (ids into ``vectors``,
    an array or a tensor); no replies at all is not correct.  Recall is taken over the replies ``recall_mask`` marks (all
    by default); every reply is held to the per-reply rules.  Returns
    ``{"correct": bool, "checks": {name: [value, limit]}, "recall":
    float}``; a count's limit is the most allowed, ``recall``'s the
    least."""
    qidx = np.asarray(qidx, np.int64)
    ids = np.asarray(ids, np.int64).reshape(len(qidx), k)
    dists = np.asarray(dists, np.float64).reshape(len(qidx), k)
    gold, _ = exact_knn(vectors, attrs, queries, ranges, k, device=device)
    bad = bad_replies(ids, dists, attrs, ranges[qidx])
    exact, scale = pair_dists(vectors, queries, qidx, ids, device=device)
    valid = (ids >= 0) & (ids < len(vectors))
    gap = np.abs(np.where(valid, dists, 0.0) - np.where(valid, exact, 0.0))
    gap = float((gap / scale).max()) if len(ids) else 0.0
    mask = (np.ones(len(qidx), bool) if recall_mask is None
            else np.asarray(recall_mask, bool))
    rec = recall_at_k(ids[mask], gold[qidx[mask]])
    recall = float(rec.mean()) if len(rec) else 0.0
    checks = {
        "unanswered": [int(unanswered), 0],
        "bad_replies": [int(bad.sum()), 0],
        "dist_gap": [gap, float(limits["dist_gap_max"])],
        "recall": [recall, float(limits["recall_min"])],
    }
    ok = all(v <= lim for name, (v, lim) in checks.items() if name != "recall")
    ok = ok and recall >= checks["recall"][1] and len(rec) > 0
    return {"correct": bool(ok), "checks": checks, "recall": recall}
