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


@pytest.mark.cuda
@pytest.mark.parametrize("vec_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,B,K,D", [(32768, 8, 17, 128), (32768, 256, 17, 128),
                                     (64, 5, 9, 33), (200, 4, 33, 24)])
def test_cuda_kernel_matches_plain(cuda_device, n, B, K, D, vec_dtype):
    """The hand-written kernel against its plain version on the card, at
    the serving shape and at ragged widths (scalar path), with
    out-of-range ids."""
    from repro_torch.kernels.gather_distance import LAUNCHES, gather_norm_dot

    rng = np.random.default_rng(D + K)
    f32 = rng.normal(size=(n, D)).astype(np.float32)
    _, _, tt, ts = _tables(f32, vec_dtype)
    tt = tt.to(cuda_device)
    ts = None if ts is None else ts.to(cuda_device)
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
