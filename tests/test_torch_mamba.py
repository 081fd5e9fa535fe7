"""repro_torch Mamba scan, Mamba mixer and MoE layer vs the JAX package on
the CPU, and — on a card — the ``mamba_scan`` CUDA kernel against its
plain version.

The reference's Pallas ``mamba_scan`` cannot run under the installed jax
(it calls ``pl.store``, which ``jax.experimental.pallas`` no longer has),
so the plain scan ``mamba_scan_ref`` is held against the jnp
``repro.models.mamba._ssm_scan`` and the mixer against JAX's
``backend="ref"`` branch, which runs it.

Tolerances: 2e-5 (rtol and atol) for the scan, the JAX package's own
tolerance for this kernel (``tests/test_kernels.py``); 2e-5 absolute for
the mixer and MoE outputs, where both sides do the same f32 arithmetic in
another order (outputs ~1), and for the aux loss (~1).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoECfg as JaxMoECfg
from repro.configs import get_arch as jax_arch
from repro.models import mamba as jmam
from repro.models import moe as jmoe
from repro.models.layers import split_tree
from repro_torch.configs import MoECfg, get_arch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba as tmam
from repro_torch.models import moe as tmoe
from repro_torch.models import init_params, param_count

JAMBA = "jamba-1.5-large-398b"
TOL = 2e-5


def _scan_inputs(B, T, di, N, seed=0, h0=True):
    rng = np.random.default_rng(seed)
    A = -np.exp(rng.normal(size=(di, N))).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, di)) - 1.0)).astype(
        np.float32)  # softplus, as the mixer gives it
    Bm, Cm = (rng.normal(size=(B, T, N)).astype(np.float32)
              for _ in range(2))
    x = rng.normal(size=(B, T, di)).astype(np.float32)
    h = (rng.normal(size=(B, di, N)) if h0 else np.zeros((B, di, N)))
    return A, dt, Bm, Cm, x, h.astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _noisy(tree, seed):
    """A JAX init's value tree with seeded noise on every leaf (the
    zero-initialised conv bias too), as numpy arrays."""
    rng = np.random.default_rng(seed)
    values, _ = split_tree(tree)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), values)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("B,T,di,N,chunk,h0", [
    (2, 13, 16, 4, 4, True),  # T prime: JAX's chunk shrinks to 1
    (2, 24, 32, 8, 8, True),
    (1, 20, 8, 16, 64, False),  # chunk > T
    (3, 1, 4, 4, 8, True),
])
def test_mamba_scan_ref_matches_jax(B, T, di, N, chunk, h0):
    args = _scan_inputs(B, T, di, N, seed=T + di, h0=h0)
    y, hT = tref.mamba_scan_ref(*_t(*args), chunk=chunk)
    jy, jh = jmam._ssm_scan(*(jnp.asarray(a) for a in args), chunk)
    assert y.dtype == hT.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)


def test_mamba_scan_dispatch_on_cpu():
    """auto and ref = the plain version for CPU tensors; cuda on a CPU
    tensor raises; the kernel wrapper refuses CPU tensors."""
    from repro_torch.kernels.mamba_scan import LAUNCHES, mamba_scan

    args = _t(*_scan_inputs(2, 9, 8, 4))
    before = dict(LAUNCHES)
    want = tref.mamba_scan_ref(*args)
    for backend in ("auto", "ref"):
        for a, b in zip(tops.mamba_scan(*args, backend=backend), want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tops.mamba_scan(*args, backend="cuda")
    with pytest.raises(ValueError):
        tops.mamba_scan(*args, backend="pallas")
    with pytest.raises(ValueError):
        mamba_scan(*args)
    assert LAUNCHES == before  # nothing launched


def _mamba_pair(seed=0):
    cfg, tcfg = jax_arch(JAMBA).reduced(), get_arch(JAMBA).reduced()
    vals = _noisy(jmam.mamba_init(jax.random.PRNGKey(seed), cfg), seed)
    return cfg, tcfg, vals, _torch_tree(vals)


def _state_pair(cfg, B, seed):
    rng = np.random.default_rng(seed)
    _, di, _ = jmam._dims(cfg)
    conv = rng.normal(size=(B, cfg.mamba.d_conv - 1, di)).astype(np.float32)
    h = rng.normal(size=(B, di, cfg.mamba.d_state)).astype(np.float32)
    return (jmam.MambaState(conv=jnp.asarray(conv), h=jnp.asarray(h)),
            tmam.MambaState(*_t(conv, h)))


@pytest.mark.parametrize("T", [16, 2])  # 2 < d_conv - 1: the tail concat
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_mamba_train_matches_jax(T, with_state, backend):
    cfg, tcfg, vals, tp = _mamba_pair()
    B = 2
    x = 0.5 * np.random.default_rng(3).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)
    js, ts = _state_pair(cfg, B, 4) if with_state else (None, None)
    jy, jst = jmam.mamba_train(jax.tree.map(jnp.asarray, vals), cfg,
                               jnp.asarray(x), state=js, backend="ref")
    ty, tst = tmam.mamba_train(tp, tcfg, torch.from_numpy(x), state=ts,
                               backend=backend)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    if not with_state:
        assert tst is None and jst is None
        return
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), rtol=0,
                               atol=TOL)
    assert tst.h.dtype == torch.float32


def test_mamba_decode_matches_jax():
    """Four decode steps from a nonzero state, the state carried."""
    cfg, tcfg, vals, tp = _mamba_pair(seed=1)
    jv = jax.tree.map(jnp.asarray, vals)
    B = 3
    js, ts = _state_pair(cfg, B, 5)
    rng = np.random.default_rng(6)
    for _ in range(4):
        x = 0.5 * rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        jy, js = jmam.mamba_decode(jv, cfg, jnp.asarray(x), js)
        ty, ts = tmam.mamba_decode(tp, tcfg, torch.from_numpy(x), ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(ts.conv.numpy(), np.asarray(js.conv),
                                   rtol=0, atol=TOL)


def test_mamba_prefill_then_decode_equals_train():
    """The port against itself: prefill of T tokens then one decode step
    gives the train-mode output of T + 1 tokens at the last position."""
    _, tcfg, _, tp = _mamba_pair(seed=2)
    B, T = 2, 12
    x = torch.from_numpy(0.5 * np.random.default_rng(7).normal(
        size=(B, T + 1, tcfg.d_model)).astype(np.float32))
    full, _ = tmam.mamba_train(tp, tcfg, x)
    st = tmam.make_mamba_state(tcfg, B, torch.float32, device="cpu")
    _, st = tmam.mamba_train(tp, tcfg, x[:, :T], state=st)
    last, _ = tmam.mamba_decode(tp, tcfg, x[:, T:], st)
    torch.testing.assert_close(last, full[:, T:], rtol=0, atol=TOL)


MOE_CASES = {  # name -> (MoE fields, tokens B x T)
    "jamba": (dict(num_experts=4, top_k=2), (2, 16)),
    # 256 assignments over 4 experts at capacity factor 0.25: C = 32, so
    # the hot experts drop tokens
    "drops": (dict(num_experts=4, top_k=2, capacity_factor=0.25), (4, 32)),
    # qwen2-moe's kind: shared experts, 6 routed padded to 8 dead-tailed
    "shared_padded": (dict(num_experts=6, top_k=2, num_shared=1,
                           pad_to=8), (2, 24)),
    # deepseek's kind: top-3 of 8 with two shared experts, one token
    "decode": (dict(num_experts=8, top_k=3, num_shared=2), (3, 1)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    fields, (B, T) = MOE_CASES[case]
    fields = dict(fields, d_ff_expert=16)
    d = 32
    jcfg, tcfg = JaxMoECfg(**fields), MoECfg(**fields)
    vals = _noisy(jmoe.moe_init(jax.random.PRNGKey(3), jcfg, d, 64), 3)
    x = np.random.default_rng(8).normal(size=(B, T, d)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, vals), jcfg,
                              jnp.asarray(x))
    ty, taux = tmoe.moe_apply(_torch_tree(vals), tcfg, torch.from_numpy(x))
    assert ty.shape == (B, T, d) and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=TOL)
    assert tuple(vals["wi_gate"].shape) == (tcfg.padded_experts, d, 16)
    # the case exercises what it names
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, d))
                          @ torch.from_numpy(vals["router"]), -1)
    counts = torch.bincount(torch.topk(probs, tcfg.top_k).indices.reshape(-1),
                            minlength=tcfg.num_experts)
    dropped = int(counts.max()) > tmoe.capacity(tcfg, B * T)
    assert dropped == (case == "drops")


def test_moe_init_distributions():
    """Expert weights: a truncated normal within 2/sqrt(E * d) (JAX's
    fan-in of an [E, d, f] weight), drawn expert by expert; the router
    and the shared experts are plain dense weights."""
    cfg = MoECfg(num_experts=6, top_k=2, num_shared=1, d_ff_expert=24,
                 pad_to=8)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, 32, 64,
                      device="cpu", dtype=torch.bfloat16)
    assert p["router"].shape == (32, 6)
    assert p["wi_gate"].shape == p["wi_up"].shape == (8, 32, 24)
    assert p["wo"].shape == (8, 24, 32)
    assert p["shared"]["wi_gate"].shape == (32, 24)
    for name in ("wi_gate", "wi_up", "wo"):
        w = p[name].float()
        assert p[name].dtype == torch.bfloat16
        bound = 2.0 / (w.shape[0] * w.shape[1]) ** 0.5
        assert float(w.abs().max()) <= bound * (1 + 2 ** -8)
        assert float(w.std()) > 0.25 * bound
        assert not torch.equal(w[0], w[1])  # each expert its own draw


def test_jamba_five_layer_cut():
    """The cut served on one card: layers 0-4 of the full config (Mamba +
    MLP, Mamba + MoE, Mamba + MLP, Mamba + MoE, attention + MLP), 24.05 B
    parameters, 44.8 GiB in bf16 (counted on the meta device)."""
    for get in (get_arch, jax_arch):
        full = get(JAMBA)
        cut = dataclasses.replace(full, num_layers=5,
                                  block_pattern=full.block_pattern[:5])
        kinds = [(cut.mixer_kind(i), cut.is_moe_layer(i)) for i in range(5)]
        assert kinds == [(full.mixer_kind(i), full.is_moe_layer(i))
                         for i in range(5)]
        assert kinds == [("mamba", False), ("mamba", True), ("mamba", False),
                         ("mamba", True), ("attn", False)]
    params = init_params(cut, torch.Generator(), device="meta",
                         dtype=torch.bfloat16)
    n = param_count(params)
    assert n == 24_045_707_264
    assert round(n * 2 / 2 ** 30, 1) == 44.8


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
@pytest.mark.parametrize("B,T,di,N", [(2, 100, 200, 16), (1, 37, 130, 4),
                                      (3, 1, 256, 16), (2, 130, 64, 8),
                                      (1, 70, 96, 64), (2, 203, 301, 16),
                                      (1, 64, 260, 16), (2, 75, 300, 4),
                                      (1, 45, 130, 64), (1, 33, 257, 5)])
@pytest.mark.parametrize("h0", [False, True])
def test_cuda_mamba_scan_matches_plain(cuda_device, B, T, di, N, h0):
    """The kernel against the plain step scan within the JAX package's
    2e-5: at di that are no multiple of a block's 256 channels (or 128 at
    N 32 and 64) nor of a thread's 2, odd di (4-byte staging copies), T
    that are no multiple of the 8-step staging chunk, T = 1, and N 4, 5
    (padded to 8), 8, 16 and 64."""
    from repro_torch.kernels.mamba_scan import LAUNCHES, mamba_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    args = tuple(a.to(cuda_device) for a in _t(*_scan_inputs(
        B, T, di, N, seed=T + di, h0=h0)))
    before = LAUNCHES["mamba_scan"]
    y, hT = mamba_scan(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["mamba_scan"] == before + 1
    ey, eh = tref.mamba_scan_ref(*args)
    torch.testing.assert_close(y, ey, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hT, eh, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_cuda_mamba_scan_loguniform_dt(cuda_device):
    """The kernel within 2e-5 of the scan in f64 at the CPU rounding
    study's shape (B 2, T 2,048, di 256, N 16), A = -exp(N(0, 1)) and dt
    as Mamba's dt init spans it, log-uniform on [1e-3, 1e-1]: decays so
    close to 1 that an exponential's error of one sign builds up in h over
    the whole sequence (tests/test_torch_mamba_exp_rounding.py).  Held
    against the f64 scan, not the plain version: on an H100 the plain
    version in f32 is itself 2.1x the rule off the f64 scan here (0.38x
    on the CPU)."""
    from test_torch_mamba_exp_rounding import scan_f64

    from repro_torch.kernels.mamba_scan import mamba_scan

    A, _, Bm, Cm, x, h0 = _scan_inputs(2, 2048, 256, 16, seed=5)
    rng = np.random.default_rng(6)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), x.shape)).astype(
        np.float32)
    args = _t(A, dt, Bm, Cm, x, h0)
    y, hT = mamba_scan(*(a.to(cuda_device) for a in args))
    ey, eh = scan_f64(*args)
    torch.testing.assert_close(y.cpu().double(), ey, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hT.cpu().double(), eh, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_cuda_mamba_scan_unaligned_rows(cuda_device):
    """dt and x as contiguous views 1 float into their storage: rows no
    longer 16-byte aligned, so the kernel stages them with 4-byte copies;
    within 2e-5 of the plain scan."""
    from repro_torch.kernels.mamba_scan import mamba_scan

    A, dt, Bm, Cm, x, h0 = _t(*_scan_inputs(2, 50, 260, 16, seed=8))
    views = []
    for a in (dt, x):
        store = torch.empty(1 + a.numel(), device=cuda_device)
        store[1:] = a.flatten().to(cuda_device)
        views.append(store[1:].view(a.shape))
    dt, x = views
    A, Bm, Cm, h0 = (a.to(cuda_device) for a in (A, Bm, Cm, h0))
    y, hT = mamba_scan(A, dt, Bm, Cm, x, h0)
    ey, eh = tref.mamba_scan_ref(A, dt, Bm, Cm, x, h0)
    torch.testing.assert_close(y, ey, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hT, eh, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_cuda_mamba_train_goes_through_the_kernel(cuda_device):
    """The mixer on CUDA tensors launches the kernel once and agrees with
    its ``backend="ref"`` run."""
    from repro_torch.kernels.mamba_scan import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, tcfg, _, tp = _mamba_pair()
    tp = jax.tree.map(lambda t: t.to(cuda_device), tp)
    x = torch.from_numpy(0.5 * np.random.default_rng(3).normal(
        size=(2, 40, tcfg.d_model)).astype(np.float32)).to(cuda_device)
    before = LAUNCHES["mamba_scan"]
    got, _ = tmam.mamba_train(tp, tcfg, x, backend="auto")
    torch.cuda.synchronize()
    assert LAUNCHES["mamba_scan"] == before + 1
    want, _ = tmam.mamba_train(tp, tcfg, x, backend="ref")
    assert LAUNCHES["mamba_scan"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
