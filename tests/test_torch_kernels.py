"""repro_torch kernels vs the JAX package: the plain torch versions against
the jnp oracles and the Pallas kernel (interpret mode), the dispatch
policy, the merge writeback, and — on a card — the CUDA kernel against its
plain version.

Tolerance of the gather kernels: rtol 1e-5 and atol 1e-5*|v|*|q| per
element (|v|^2 for the squared norm).  Dequant is exact in f32 in both
packages, so the only difference is summation order.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.store import quantize_rows as ref_quantize_rows
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gather_distance import gather_norm_dot as pallas_gnd
from repro_torch.core.store import quantize_rows
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SWEEP = [  # (n, B, K, D, rows) — the Pallas slab sweep of test_kernels.py
    (50, 2, 7, 16, 4),
    (200, 4, 33, 8, 8),
    (33, 1, 1, 5, 8),
    (64, 5, 9, 128, 3),
]


def _tables(f32: np.ndarray, vec_dtype: str):
    """The same f32 rows stored as ``vec_dtype`` in both packages ->
    (jax table, jax scales, torch table, torch scales)."""
    slab, scales = ref_quantize_rows(f32, vec_dtype)
    tslab, tscales = quantize_rows(f32, vec_dtype)
    if vec_dtype == "bf16":
        tt = torch.from_numpy(tslab.view(np.int16)).view(torch.bfloat16)
    else:
        tt = torch.from_numpy(tslab)
    return (jnp.asarray(slab), None if scales is None else jnp.asarray(scales),
            tt, None if tscales is None else torch.from_numpy(tscales))


def _assert_close(got, exp, vnorm, qnorm):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    atol = 1e-5 * vnorm * qnorm
    assert np.all(np.abs(got - exp) <= 1e-5 * np.abs(exp) + atol + 1e-30), (
        np.max(np.abs(got - exp) - 1e-5 * np.abs(exp) - atol))


@pytest.mark.parametrize("vec_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,B,K,D,rows", SWEEP)
def test_gather_norm_dot_ref_matches_jax(n, B, K, D, rows, vec_dtype):
    """Port plain version == jnp oracle == Pallas kernel (interpret), with
    out-of-range ids (clipped, not out of bounds)."""
    rng = np.random.default_rng(n * 31 + K)
    f32 = rng.normal(size=(n, D)).astype(np.float32)
    ids = rng.integers(-3, n + 3, size=(B, K)).astype(np.int32)
    qs = rng.normal(size=(B, D)).astype(np.float32)
    jt, js, tt, ts = _tables(f32, vec_dtype)
    td, tv = tref.gather_norm_dot_ref(tt, torch.from_numpy(ids),
                                      torch.from_numpy(qs), scales=ts)
    jd, jv = jref.gather_norm_dot_ref(jt, jnp.asarray(ids), jnp.asarray(qs),
                                      scales=js)
    pd, pv = pallas_gnd(jt, jnp.asarray(ids), jnp.asarray(qs), scales=js,
                        rows=rows, interpret=True)
    vnorm = np.sqrt(np.asarray(jv, np.float64))
    qnorm = np.linalg.norm(qs.astype(np.float64), axis=1)[:, None]
    for exp_d, exp_v in ((jd, jv), (pd, pv)):
        _assert_close(td, exp_d, vnorm, qnorm)
        _assert_close(tv, exp_v, vnorm, vnorm)


@pytest.mark.parametrize("n,B,K,D", [(50, 2, 7, 16), (200, 4, 33, 8)])
def test_gather_dot_ref_matches_jax(n, B, K, D):
    """jnp gather semantics: negative ids wrap once, ids past the end
    clamp to the last row."""
    rng = np.random.default_rng(n)
    table = rng.normal(size=(n, D)).astype(np.float32)
    ids = rng.integers(-n, n + 5, size=(B, K)).astype(np.int32)
    qs = rng.normal(size=(B, D)).astype(np.float32)
    got = tops.gather_dot(torch.from_numpy(table), torch.from_numpy(ids),
                          torch.from_numpy(qs))
    exp = jops.gather_dot(jnp.asarray(table), jnp.asarray(ids),
                          jnp.asarray(qs), backend="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-5)


def _random_bijection(rng, B, W, K):
    perm = np.stack([rng.permutation(W + K) for _ in range(B)])
    return perm[:, :W].astype(np.int32), perm[:, W:].astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_src_indices_bitwise(seed):
    """All three writeback methods agree bitwise with JAX's and with each
    other on random position bijections."""
    rng = np.random.default_rng(seed)
    B, W, K = 6, 24, 9
    pa, pb = _random_bijection(rng, B, W, K)
    outs = []
    for method in ("sort", "scatter", "onehot", "auto"):
        got = tops.merge_src_indices(torch.from_numpy(pa),
                                     torch.from_numpy(pb), W, K,
                                     method=method).numpy()
        outs.append(got)
        if method != "auto":  # JAX's auto picks per platform
            exp = np.asarray(jops.merge_src_indices(
                jnp.asarray(pa), jnp.asarray(pb), W, K, method=method))
            np.testing.assert_array_equal(got, exp)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    with pytest.raises(ValueError):
        tops.merge_src_indices(torch.from_numpy(pa), torch.from_numpy(pb),
                               W, K, method="bogus")


def test_dispatch_policy_on_cpu():
    """auto = plain version for a CPU tensor; cuda on a CPU tensor raises;
    the kernel wrapper itself refuses CPU tensors."""
    from repro_torch.kernels.gather_distance import gather_norm_dot

    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, size=(3, 5)))
    qs = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    a = tops.gather_norm_dot(table, ids, qs, backend="auto")
    r = tops.gather_norm_dot(table, ids, qs, backend="ref")
    for x, y in zip(a, r):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tops.gather_norm_dot(table, ids, qs, backend="cuda")
    with pytest.raises(ValueError):
        tops.gather_norm_dot(table, ids, qs, backend="pallas")
    with pytest.raises(ValueError):
        gather_norm_dot(table, ids, qs)


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


CUDA_CASES = [  # (n, B, K, D, offset): table = rows[offset:]
    # the serving shapes, and ragged widths
    (32768, 8, 17, 128, 0), (32768, 256, 17, 128, 0), (64, 5, 9, 33, 0),
    (200, 4, 33, 24, 0),
    # each width round the lane groups' thresholds
    *[(300, 3, 17, D, 0) for D in (24, 33, 48, 64, 127, 128, 129, 256, 768)],
    (300, 5, 1, 128, 0), (300, 5, 48, 128, 0),  # K = 1 and 48
    (300, 1, 3, 128, 0), (300, 3, 7, 40, 0),  # B K short of a warp's rows
    # a contiguous row slice: a table base past a 16-byte boundary
    (100, 4, 5, 33, 1), (100, 4, 5, 127, 1), (100, 4, 5, 129, 1),
    (1, 2, 5, 33, 0), (1, 3, 4, 128, 0),  # n = 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("vec_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,B,K,D,offset", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, n, B, K, D, offset,
                                   vec_dtype):
    """The hand-written kernel against its plain version on the card, at
    the serving shape, at every lane-group boundary of the row's width, at
    ragged widths, short and ragged warps and unaligned tables (narrow
    loads at the row ends), with out-of-range ids."""
    from repro_torch.kernels.gather_distance import LAUNCHES, gather_norm_dot

    rng = np.random.default_rng(D + K)
    f32 = rng.normal(size=(n + offset, D)).astype(np.float32)
    _, _, tt, ts = _tables(f32, vec_dtype)
    tt = tt.to(cuda_device)[offset:]
    ts = None if ts is None else ts.to(cuda_device)[offset:]
    ids = torch.from_numpy(rng.integers(-3, n + 3, size=(B, K))).to(cuda_device)
    qs = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(
        cuda_device)
    before = LAUNCHES["gather_norm_dot"]
    kd, kv = gather_norm_dot(tt, ids, qs, scales=ts)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_norm_dot"] == before + 1
    rd, rv = tref.gather_norm_dot_ref(tt, ids, qs, scales=ts)
    vnorm = np.sqrt(rv.double().cpu().numpy())
    qnorm = qs.double().norm(dim=1).cpu().numpy()[:, None]
    _assert_close(kd.cpu(), rd.cpu(), vnorm, qnorm)
    _assert_close(kv.cpu(), rv.cpu(), vnorm, vnorm)


def _source_constants(*keys) -> dict:
    import re
    from pathlib import Path

    src = (Path(tref.__file__).resolve().parents[1] / "csrc"
           / "gather_norm_dot.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in keys}


def _first_query(r0, K: int, rows: int):
    """The kernel's query of row r0: (r0 + 1/2) * (1/K) in f32, truncated,
    while rows < 2^22, else the integer division."""
    r0 = np.asarray(r0, np.int64)
    if rows < (1 << 22):
        inv_k = np.float32(1) / np.float32(K)
        return ((r0.astype(np.float32) + np.float32(0.5)) * inv_k).astype(
            np.int64)
    return r0 // K


def test_gather_row_to_query_mapping():
    """The CUDA kernel's row -> (query, group, lane) mapping, emulated in
    numpy: the f32 query of a warp's first row equals r0 // K for every row
    below 2^22 and K <= 64 (and misses just above, so the integer division
    there is needed); each group's query, stepped on from it, is its row's;
    each row is stored once, by its group's first lane; and the lane groups
    sized to the row give each lane 1-4 words of 4 values at D = 128."""
    limit = 1 << 22
    r = np.arange(limit, dtype=np.int64)
    for K in range(1, 65):
        assert np.array_equal(_first_query(r, K, limit - 1), r // K), K
    above = np.arange(limit, limit + (1 << 20), dtype=np.int64)
    assert not np.array_equal(_first_query(above, 63, limit - 1), above // 63)
    assert np.array_equal(_first_query(above, 63, limit + (1 << 20)),
                          above // 63)

    c = _source_constants("kMax8", "kMax16")
    rng = np.random.default_rng(0)
    for D in (24, 48, 128, 768):
        G = 8 if D <= c["kMax8"] else 16 if D <= c["kMax16"] else 32
        if D == 128:
            assert 1 <= D // 4 // G <= 4, G
        R = 32 // G
        for K in (1, 17, 48):
            for B in (1, 7, 256):
                rows = B * K
                for r0 in range(0, rows, R):  # one warp a step
                    lane = np.arange(32)
                    g = lane // G
                    live = r0 + g < rows
                    b = _first_query(r0, K, rows) + np.zeros(32, np.int64)
                    k = r0 - b * K + g
                    while (k >= K).any():  # the kernel's carry loop
                        b, k = b + (k >= K), k - K * (k >= K)
                    assert np.array_equal(b[live], (r0 + g[live]) // K)
                    stores = r0 + g[(lane % G == 0) & live]
                    assert np.array_equal(stores, np.arange(
                        r0, min(r0 + R, rows)))
        big = int(rng.integers(limit, 1 << 30))
        assert _first_query(big, 48, big + 1) == big // 48
