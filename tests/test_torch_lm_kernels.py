"""repro_torch LM kernels vs the JAX package: the plain torch versions
(``mha_ref``, ``wkv6_ref``, ``wkv6_chunked``) against the jnp oracles and
the Pallas kernels (interpret mode), the dispatch policy, and — on a card —
each CUDA kernel against its plain version.

Tolerances are those of the JAX package's own kernel tests
(``tests/test_kernels.py``): rtol/atol 2e-4 for attention, 3e-4 for the
WKV recurrence; the blocked span path against the dense one 2e-5.  On the
card the bf16 flash kernel is held against the plain version on the same
bf16 inputs upcast to f32 within ``ref.mha_tolerance``: 2e-4 plus the
bf16 rounding of its output (2^-8 relative) and of the probabilities it
multiplies V by on the tensor cores (2^-8 of sum_j p_j |v_j| / l; the
CPU emulation in ``test_torch_flash_rounding.py`` justifies it).  The f32
kernel (3xTF32 on the tensor cores) keeps 2e-4
(``test_torch_flash_tf32_rounding.py`` emulates its arithmetic).  The
bf16 ``wkv6`` output is held against the plain version on the inputs
upcast to f32 within 3e-4 plus its own bf16 rounding (2^-8 relative).
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rwkv6 import wkv6 as pallas_wkv6
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _attn_inputs(B, Tq, Tk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)))


def _wkv_inputs(B, H, T, N, seed=0, lo=0.05):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, T, N)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(lo, 0.999, size=(B, H, T, N)).astype(np.float32)
    u = rng.normal(size=(H, N)).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, N)).astype(np.float32)
    return r, k, v, w, u, s0


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 16])
def test_mha_ref_matches_jax(Hq, Hkv, window):
    """Port ``mha_ref`` == Pallas flash (interpret, 16 x 16 blocks) ==
    jnp ``mha_ref``, causal, GQA, with and without a window."""
    q, k, v = _attn_inputs(2, 64, 64, Hq, Hkv, 16, seed=Hq + Hkv)
    got = tref.mha_ref(*_t(q, k, v), causal=True, window=window).numpy()
    pal = pallas_flash(*_j(q, k, v), causal=True, window=window,
                       block_q=16, block_k=16, interpret=True)
    exp = jref.mha_ref(*_j(q, k, v), causal=True, window=window)
    for e in (pal, exp):
        np.testing.assert_allclose(got, np.asarray(e), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [None, 24])
def test_mha_ref_q_offset_matches_jax(window):
    """Queries at absolute positions 32.. over 48 keys (a prefix already
    cached), against both JAX versions."""
    q, k, v = _attn_inputs(2, 16, 48, 4, 2, 16, seed=3)
    got = tref.mha_ref(*_t(q, k, v), causal=True, window=window,
                       q_offset=32).numpy()
    pal = pallas_flash(*_j(q, k, v), causal=True, window=window, q_offset=32,
                       block_q=16, block_k=16, interpret=True)
    exp = jref.mha_ref(*_j(q, k, v), causal=True, window=window, q_offset=32)
    for e in (pal, exp):
        np.testing.assert_allclose(got, np.asarray(e), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (32, 0), (32, 16)])
def test_mha_ref_block_q_span_path(window, q_offset):
    """The blocked span path (``block_q``) against the jnp blocked path and
    the port's dense path."""
    q, k, v = _attn_inputs(2, 96, 96 + q_offset, 4, 2, 16, seed=5)
    got = tref.mha_ref(*_t(q, k, v), causal=True, window=window,
                       q_offset=q_offset, block_q=16).numpy()
    exp = jref.mha_ref(*_j(q, k, v), causal=True, window=window,
                       q_offset=q_offset, block_q=16)
    dense = tref.mha_ref(*_t(q, k, v), causal=True, window=window,
                         q_offset=q_offset).numpy()
    np.testing.assert_allclose(got, np.asarray(exp), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        tref.mha_ref(*_t(q, k, v), block_q=20)


def test_ops_flash_attention_blocks_long_queries():
    """The plain dispatch takes the blocked path once Tq reaches
    ``attn_blocked_min_t`` (the JAX wrapper's policy), with equal results."""
    from repro_torch.models.tuning import TUNING, set_tuning

    q, k, v = _t(*_attn_inputs(1, 64, 64, 4, 4, 16, seed=7))
    old = (TUNING.attn_blocked_min_t, TUNING.attn_block_q)
    try:
        set_tuning(attn_blocked_min_t=64, attn_block_q=16)
        blocked = tops.flash_attention(q, k, v, window=8, backend="ref")
    finally:
        set_tuning(attn_blocked_min_t=old[0], attn_block_q=old[1])
    dense = tref.mha_ref(q, k, v, window=8)
    np.testing.assert_allclose(blocked.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("B,H,T,N,chunk", [(1, 1, 16, 8, 4), (2, 3, 64, 16, 16),
                                           (1, 2, 96, 32, 32)])
def test_wkv6_matches_jax(B, H, T, N, chunk):
    """Port ``wkv6_ref`` and ``wkv6_chunked`` == Pallas wkv6 (interpret) ==
    jnp ``wkv6_ref`` == jnp ``wkv6_chunked``, from a nonzero state."""
    arrs = _wkv_inputs(B, H, T, N, seed=T)
    r, k, v, w, u, s0 = _t(*arrs)
    jr, jk, jv, jw, ju, js = _j(*arrs)
    outs = {
        "port step": tref.wkv6_ref(r, k, v, w, u, state=s0),
        "port chunked": tref.wkv6_chunked(r, k, v, w, u, state=s0,
                                          chunk=chunk),
    }
    exps = {
        "pallas": pallas_wkv6(jr, jk, jv, jw, ju, state=js, chunk=chunk,
                              interpret=True),
        "jnp step": jref.wkv6_ref(jr, jk, jv, jw, ju, state=js),
        "jnp chunked": jref.wkv6_chunked(jr, jk, jv, jw, ju, state=js,
                                         chunk=chunk),
    }
    for (y, s) in outs.values():
        for (ey, es) in exps.values():
            np.testing.assert_allclose(y.numpy(), np.asarray(ey), rtol=3e-4,
                                       atol=3e-4)
            np.testing.assert_allclose(s.numpy(), np.asarray(es), rtol=3e-4,
                                       atol=3e-4)


@pytest.mark.parametrize("T,chunk", [(50, 16), (37, 8)])
def test_wkv6_chunked_ragged_T_matches_jax(T, chunk):
    """A T that is no multiple of the chunk: the chunk shrinks until it
    divides T, in both packages (the Pallas kernel refuses such a T)."""
    arrs = _wkv_inputs(2, 2, T, 16, seed=T, lo=0.2)
    r, k, v, w, u, s0 = _t(*arrs)
    jr, jk, jv, jw, ju, js = _j(*arrs)
    y, s = tref.wkv6_chunked(r, k, v, w, u, state=s0, chunk=chunk)
    ey, es = jref.wkv6_chunked(jr, jk, jv, jw, ju, state=js, chunk=chunk)
    sy, ss = jref.wkv6_ref(jr, jk, jv, jw, ju, state=js)
    for a, b in ((y, ey), (s, es), (y, sy), (s, ss)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-4)


def test_lm_kernel_dispatch_on_cpu():
    """auto = plain version for CPU tensors; cuda on a CPU tensor raises;
    the kernel wrappers refuse CPU tensors."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6 import wkv6

    q, k, v = _t(*_attn_inputs(1, 8, 8, 2, 1, 8))
    assert torch.equal(tops.flash_attention(q, k, v),
                       tref.mha_ref(q, k, v))
    r, kk, vv, w, u, s0 = _t(*_wkv_inputs(1, 2, 8, 4))
    for a, b in zip(tops.wkv6(r, kk, vv, w, u, state=s0),
                    tref.wkv6_ref(r, kk, vv, w, u, state=s0)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError):
        tops.wkv6(r, kk, vv, w, u, backend="cuda")
    with pytest.raises(ValueError):
        tops.wkv6(r, kk, vv, w, u, backend="pallas")
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    with pytest.raises(ValueError):
        wkv6(r, kk, vv, w, u)


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


FLASH_CASES = [  # (B, Tq, Tk, Hq, Hkv, D, window, q_offset)
    (2, 64, 64, 4, 4, 16, None, 0),
    (2, 100, 100, 8, 2, 64, None, 0),  # ragged T
    (1, 200, 200, 8, 2, 120, 48, 0),  # danube's head size, a window
    (2, 130, 130, 4, 1, 128, None, 0),
    (2, 33, 161, 4, 2, 128, None, 128),  # q_offset, ragged both
    (1, 70, 70, 2, 2, 64, 16, 0),
    (1, 256, 256, 64, 8, 128, None, 0),  # Jamba's heads
    (2, 40, 200, 4, 2, 128, None, 160),  # Tq < 64 over a full 128-key tile
    # more 128-row work items than an H100 has SMs (132): bf16 blocks walk
    # several items each
    (1, 640, 640, 32, 8, 128, None, 0),
    (2, 520, 520, 16, 4, 64, 200, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    from repro_torch.kernels.flash_attention import LAUNCHES, flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    B, Tq, Tk, Hq, Hkv, D, window, q_offset = case
    q, k, v = (a.to(cuda_device) for a in _t(*_attn_inputs(
        B, Tq, Tk, Hq, Hkv, D, seed=Tq + D)))
    if dtype == "bf16":
        q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    kw = dict(causal=True, window=window, q_offset=q_offset)
    exp = tref.mha_ref(q.float(), k.float(), v.float(), **kw)
    exp_abs = tref.mha_ref(q.float(), k.float(), v.float().abs(), **kw)
    tol = tref.mha_tolerance(exp, exp_abs, q.dtype)
    err = (got.float() - exp).abs()
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 40])
def test_cuda_flash_attention_non_causal_matches_plain(cuda_device, window,
                                                       dtype):
    """causal=False (every key up to Tk, or the window's), ragged Tq and
    Tk, against the plain version within ``mha_tolerance``."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (a.to(cuda_device) for a in _t(*_attn_inputs(
        2, 100, 150, 8, 2, 128, seed=11)))
    if dtype == "bf16":
        q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
    kw = dict(causal=False, window=window, q_offset=0)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    exp = tref.mha_ref(q.float(), k.float(), v.float(), **kw)
    exp_abs = tref.mha_ref(q.float(), k.float(), v.float().abs(), **kw)
    err = (got.float() - exp).abs()
    assert bool((err <= tref.mha_tolerance(exp, exp_abs, q.dtype)).all()), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [12, 60])
def test_cuda_flash_attention_bf16_needs_d_multiple_of_8(cuda_device, D):
    """The bf16 kernel's TMA row strides must be 16-byte multiples: the
    wrapper refuses D % 8 != 0 with the reason, before any launch."""
    from repro_torch.kernels.flash_attention import LAUNCHES, flash_attention

    q, k, v = (a.to(cuda_device, torch.bfloat16) for a in _t(*_attn_inputs(
        1, 16, 16, 2, 1, D)))
    before = LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="D % 8"):
        flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("D", [12, 60])
def test_cuda_flash_attention_f32_small_d(cuda_device, D):
    """D % 8 != 0 in f32: the TF32 products take 8 columns a step, so the
    kernel multiplies TMA's zero fill past D; within 2e-4 of the plain
    version, causal and not, with a window."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (a.to(cuda_device) for a in _t(*_attn_inputs(
        2, 100, 100, 4, 2, D, seed=D)))
    for kw in (dict(causal=True), dict(causal=False, window=30)):
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        exp = tref.mha_ref(q, k, v, **kw)
        err = float((got - exp).abs().max())
        assert err <= tref.mha_tolerance(exp, None, torch.float32), err


@pytest.mark.cuda
@pytest.mark.parametrize("N", [32, 64])
def test_cuda_wkv6_bf16_rkv(cuda_device, N):
    """bf16 r/k/v (w, u, the state f32): y in bf16 within 3e-4 plus its
    own rounding (2^-8 relative) of the plain version on the inputs
    upcast to f32, the final state within 3e-4."""
    from repro_torch.kernels.rwkv6 import wkv6

    r, k, v, w, u, s0 = (a.to(cuda_device) for a in _t(*_wkv_inputs(
        2, 3, 50, N, seed=N + 1, lo=0.2)))
    r, k, v = (a.to(torch.bfloat16) for a in (r, k, v))
    y, s = wkv6(r, k, v, w, u, state=s0)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    ey, es = tref.wkv6_ref(r.float(), k.float(), v.float(), w, u, state=s0)
    torch.testing.assert_close(y.float(), ey, rtol=2.0 ** -8, atol=3e-4)
    torch.testing.assert_close(s, es, rtol=3e-4, atol=3e-4)


WKV6_CHUNK = {32: 16, 64: 16, 128: 8}  # N -> steps the kernel stages a chunk
WKV6_CASES = (  # (B, H, T, N)
    [(2, 4, 64, 16), (2, 3, 100, 64), (1, 2, 37, 128), (1, 2, 16, 8)]
    # T at the chunk edges: C - 1, C, C + 1, 2 C + 5
    + [(2, 3, T, N) for N, C in WKV6_CHUNK.items()
       for T in (C - 1, C, C + 1, 2 * C + 5)]
    # N no multiple of the staged rows' width: idle rows and columns
    + [(2, 2, 45, 48), (2, 2, 45, 100)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,N", WKV6_CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_cuda_wkv6_matches_plain(cuda_device, B, H, T, N, with_state):
    """The kernel against the step recurrence (same arithmetic, another
    order) and the chunked closed form, at ragged T, at the edges of the
    chunks the kernel stages and at N that is no power of two."""
    from repro_torch.kernels.rwkv6 import LAUNCHES, wkv6

    r, k, v, w, u, s0 = (a.to(cuda_device) for a in _t(*_wkv_inputs(
        B, H, T, N, seed=T + N, lo=0.2)))
    s0 = s0 if with_state else None
    before = LAUNCHES["wkv6"]
    y, s = wkv6(r, k, v, w, u, state=s0)
    torch.cuda.synchronize()
    assert LAUNCHES["wkv6"] == before + 1
    for ey, es in (tref.wkv6_ref(r, k, v, w, u, state=s0),
                   tref.wkv6_chunked(r, k, v, w, u, state=s0, chunk=32)):
        torch.testing.assert_close(y, ey, rtol=3e-4, atol=3e-4)
        torch.testing.assert_close(s, es, rtol=3e-4, atol=3e-4)
