"""Plain torch versions of the kernels (the allclose targets in tests and in
``chip_smoke.py``).  Each mirrors its jnp twin in ``repro.kernels.ref``:
same clipping, same upcast, same per-row scale."""
from __future__ import annotations

import torch


def batched_dot_ref(vecs: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """out[b, k] = <vecs[b, k, :], queries[b, :]>."""
    return torch.einsum("bkd,bd->bk", vecs, queries)


def l2_distance_ref(
    vecs: torch.Tensor, queries: torch.Tensor, sq_norms: torch.Tensor
) -> torch.Tensor:
    """out[b, k] = ||vecs[b,k] - queries[b]||^2 via the factorised form."""
    q2 = (queries * queries).sum(dim=-1)
    dots = batched_dot_ref(vecs, queries)
    return (sq_norms - 2.0 * dots + q2[:, None]).clamp(min=0.0)


def gather_dot_ref(
    table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """out[b, k] = <table[ids[b, k]], queries[b]>  (fused gather + dot).

    Index semantics of a jnp gather: negative ids wrap once, ids past the
    end clamp to the last row."""
    n = table.shape[0]
    ids = ids.long()
    idc = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return torch.einsum("bkd,bd->bk", table[idc].float(), queries.float())


def gather_norm_dot_ref(
    table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (<deq(table[ids[b,k]]), queries[b]>, |deq(table[ids[b,k]])|^2).

    Dequantizing twin of the CUDA kernel: bf16 tables upcast, int8 tables
    multiply the gathered rows by their per-row f32 ``scales`` — the
    function the kernel computes in registers (it scales an int8 row's
    two sums instead of its values), expressed over a materialized
    gather.  Each sum is an elementwise product reduced over its own row,
    so a row's bits do not depend on the batch it is computed in (an
    einsum goes to a batched matmul, whose summation order changes with
    the batch size), as the kernel's rows do not: the compaction driver
    and the sharded build search a member in batches of other sizes."""
    n = table.shape[0]
    idc = ids.long().clamp(0, n - 1)
    vecs = table[idc].float()
    if scales is not None:
        vecs = vecs * scales.float()[idc][..., None]
    queries = queries.float()
    return (
        (vecs * queries[:, None, :]).sum(dim=-1),
        (vecs * vecs).sum(dim=-1),
    )


def mha_ref(
    q: torch.Tensor,  # [B, Tq, Hq, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, D]
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    block_q: int | None = None,
) -> torch.Tensor:
    """GQA attention with optional causal/sliding-window masking (the plain
    version of ``flash_attention``).

    ``q_offset``: absolute position of q[0] relative to k[0].
    ``block_q``: evaluate query rows in blocks of ``block_q`` against the
    key span their mask can reach (``[k_lo, k_hi)``, cut at multiples of
    ``block_q`` below), so the [Tq, Tk] score matrix never materialises
    whole; Tq must be a multiple of it.  Logits are divided by sqrt(D) in
    q's type, the softmax runs in f32 and its probabilities return to q's
    type, as in ``repro.kernels.ref.mha_ref``.  A row with no visible key
    gives NaN there and here (the kernel gives 0).
    """
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    root_d = torch.sqrt(torch.tensor(float(D))).to(q.dtype).item()

    def span(q_blk, q_lo: int, k_lo: int, k_hi: int) -> torch.Tensor:
        ks, vs = k[:, k_lo:k_hi], v[:, k_lo:k_hi]
        tq = q_blk.shape[1]
        qg = q_blk.reshape(B, tq, Hkv, group, D)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, ks) / root_d
        qpos = (q_lo + q_offset
                + torch.arange(tq, device=q.device)[:, None])
        kpos = k_lo + torch.arange(k_hi - k_lo, device=q.device)[None, :]
        mask = torch.ones((tq, k_hi - k_lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits.masked_fill_(~mask, float("-inf"))
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vs)
        return out.reshape(B, tq, Hq, D)

    if block_q is None or block_q >= Tq:
        return span(q, 0, 0, Tk)
    if Tq % block_q:
        raise ValueError(f"Tq={Tq} is no multiple of block_q={block_q}")
    outs = []
    for q_lo in range(0, Tq, block_q):
        k_hi = min(q_lo + block_q + q_offset, Tk) if causal else Tk
        k_lo = 0
        if window is not None:
            k_lo = max(0, (q_lo + q_offset - window + 1) // block_q * block_q)
        outs.append(span(q[:, q_lo:q_lo + block_q], q_lo, k_lo, k_hi))
    return torch.cat(outs, dim=1)


def mha_tolerance(exp: torch.Tensor, exp_abs: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor | float:
    """Elementwise bound on |flash_attention - mha_ref| for inputs of
    ``dtype``, where ``exp = mha_ref(q, k, v)`` and ``exp_abs =
    mha_ref(q, k, |v|)`` on the inputs upcast to f32 (or f64).

    f32: 2e-4, the JAX package's attention tolerance.  bf16: the kernel
    rounds the probabilities P to bf16 for the tensor-core P V product and
    its output to bf16, so 2e-4 + 2^-8 |exp| (the output rounding) +
    2^-8 sum_j p_j |v_j| / l (the rounded terms: their error scales with
    the sum of the terms' sizes, not with the result, which can cancel).
    """
    if dtype == torch.float32:
        return 2e-4
    if dtype != torch.bfloat16:
        raise TypeError(f"no flash_attention tolerance for {dtype}")
    return 2e-4 + 2.0 ** -8 * (exp.abs() + exp_abs)


def wkv6_ref(
    r: torch.Tensor,  # [B, H, T, N]
    k: torch.Tensor,  # [B, H, T, N]
    v: torch.Tensor,  # [B, H, T, N]
    w: torch.Tensor,  # [B, H, T, N] decay in (0, 1)
    u: torch.Tensor,  # [H, N] bonus
    state: torch.Tensor | None = None,  # [B, H, N, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence, step by step (the plain version of ``wkv6``).

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    """
    B, H, T, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=r.dtype, device=r.device)
         if state is None else state)
    ys = []
    for t in range(T):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]  # [B, H, N, N]
        ys.append(torch.einsum("bhn,bhnm->bhm", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=2), S


def wkv6_chunked(
    r: torch.Tensor,  # [B, H, T, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # [H, N]
    state: torch.Tensor | None = None,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV-6: the closed form of ``repro.kernels.ref.
    wkv6_chunked`` (exponents <= 0 everywhere).  The chunk shrinks until it
    divides T.  Returns y in r's type and the state in f32."""
    B, H, T, N = r.shape
    C = min(chunk, T)
    while T % C:  # largest chunk size dividing T
        C -= 1
    nc = T // C
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state is None else state)
    rc, kc, vc, wc = (a.float().reshape(B, H, nc, C, N) for a in (r, k, v, w))
    idx = torch.arange(C, device=r.device)
    mask = (idx[:, None] > idx[None, :])[:, :, None]  # [C, C, 1]
    uf = u.float()[None, :, None, :]
    ys = []
    for c in range(nc):
        rt, kt, vt, wt = (a[:, :, c] for a in (rc, kc, vc, wc))  # [B,H,C,N]
        lw = torch.log(wt)
        L = torch.cumsum(lw, dim=2)
        L_prev = L - lw
        y_state = torch.einsum("bhcn,bhnm->bhcm", rt * torch.exp(L_prev), S)
        expo = L_prev[..., :, None, :] - L[..., None, :, :]  # [B,H,C,C,N]
        term = torch.where(mask, torch.exp(torch.clamp(expo, max=0.0)),
                           torch.zeros((), device=r.device))
        scores = (rt[..., :, None, :] * kt[..., None, :, :] * term).sum(-1)
        y_intra = torch.einsum("bhts,bhsn->bhtn", scores, vt)
        y_diag = (rt * uf * kt).sum(-1, keepdim=True) * vt
        L_end = L[..., -1:, :]  # [B, H, 1, N]
        k_dec = kt * torch.exp(L_end - L)
        S = torch.exp(L_end[..., 0, :])[..., :, None] * S + torch.einsum(
            "bhcn,bhcm->bhnm", k_dec, vt)
        ys.append(y_state + y_intra + y_diag)
    y = torch.stack(ys, dim=2).reshape(B, H, T, N)
    return y.to(r.dtype), S


def mamba_scan_ref(
    A: torch.Tensor,  # [di, N] (negative)
    dt: torch.Tensor,  # [B, T, di]
    Bm: torch.Tensor,  # [B, T, N]
    Cm: torch.Tensor,  # [B, T, N]
    x: torch.Tensor,  # [B, T, di]
    h0: torch.Tensor,  # [B, di, N]
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan, step by step in f32 (the plain version of
    ``mamba_scan``):

    h_t = exp(dt_t[..., None] * A) * h_{t-1} + (dt_t * x_t)[..., None] * B_t
    y_t = einsum("bdn,bn->bd", h_t, C_t)

    -> (y [B, T, di] f32, h_T [B, di, N] f32).  The steps are those of
    ``repro.models.mamba._ssm_scan``, whose ``chunk`` only places its
    checkpoint boundaries; it is taken and ignored, and any T is."""
    A, dt, Bm, Cm, x, h = (a.float() for a in (A, dt, Bm, Cm, x, h0))
    ys = []
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)  # [B, di, N]
        h = a * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape)
    return y, h
