"""repro_torch LM models vs the JAX package, reduced archs on the CPU.

Every JAX parameter gets seeded numpy noise (the zero-initialised QKV
biases, LoRA up-projections, decay LoRA and Mamba conv bias too, so every
path they gate does work); ``from_jax_params`` builds the port's model
from the same values.  The port's train, prefill and decode logits are
held against JAX's ``forward`` with ``backend="pallas"`` (the Pallas
kernels in interpret mode) and ``backend="ref"``; the port runs
``backend="auto"`` (CPU tensors: the plain versions) and ``"ref"``
respectively.  For Jamba the JAX side of the ``pallas`` case runs
``backend="ref"`` (its jnp ``_ssm_scan``): the reference's Pallas
``mamba_scan`` calls ``pl.store``, which the installed jax no longer
has, so JAX's Pallas forward of a Mamba arch raises.

Tolerance on the logits (max |logit| ~3.5 here): 2e-5 absolute for the
attention archs, where both sides do the same f32 arithmetic in another
order (measured <= 3.4e-6); 3e-4 for rwkv6, the wkv6 tolerance of the JAX
package's own kernel tests, since against the Pallas kernel the port's
plain path runs the step recurrence and JAX the chunked closed form
(measured 1.5e-4; 5e-5 chunked against chunked).  The train forward's
MoE aux loss (f32, 0 without MoE layers) is held to the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_arch
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.layers import split_tree
from repro_torch.configs import all_archs, get_arch
from repro_torch.models import (
    forward, from_jax_params, init_cache, init_params, param_count,
)
from repro_torch.models.model import check_supported

SUPPORTED = ["qwen1.5-4b", "qwen2-7b", "qwen3-14b", "h2o-danube-3-4b",
             "rwkv6-1.6b", "chameleon-34b", "musicgen-large",
             "deepseek-moe-16b", "jamba-1.5-large-398b", "qwen2-moe-a2.7b"]
JAMBA = "jamba-1.5-large-398b"
# one 8-layer unit of Jamba (``reduced()`` would give two), to keep the
# JAX side's compile short
REDUCED = {JAMBA: dict(num_layers=8)}


def reduced_cfgs(arch: str):
    """(JAX config, port config), reduced alike."""
    kw = REDUCED.get(arch, {})
    return jax_arch(arch).reduced(**kw), get_arch(arch).reduced(**kw)


def noisy_values(cfg, seed: int = 0) -> dict:
    """The JAX init's value tree with seeded noise on every leaf."""
    rng = np.random.default_rng(seed)
    values, _ = split_tree(jax_init_params(jax.random.PRNGKey(seed), cfg))
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), values)


def inputs(cfg, B: int, T: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return (0.1 * rng.standard_normal((B, T, cfg.d_model))).astype(
        np.float32)


def test_all_archs_registered():
    """Every arch the JAX package registers is supported by the port."""
    assert sorted(SUPPORTED) == all_archs() == sorted(jax_all_archs())
    for arch in SUPPORTED:
        check_supported(get_arch(arch))


@pytest.mark.parametrize("backends", [("pallas", "auto"), ("ref", "ref")],
                         ids=["pallas", "ref"])
@pytest.mark.parametrize("arch", SUPPORTED)
def test_forward_matches_jax(arch, backends):
    """train / prefill / decode logits and the train forward's aux loss,
    one prompt of T tokens then one decoded token; T > window for the sliding-window arch, so its decode
    runs on the ring the prefill left.  That T is a multiple of the
    window: the reference's prefill leaves the ring right only then
    (``test_window_decode_after_prefill_matches_forward`` holds the port
    at other T)."""
    jb, tb = backends
    if arch == JAMBA:  # the reference's Pallas scan cannot run (pl.store)
        jb = "ref"
    cfg, tcfg = reduced_cfgs(arch)
    vals = noisy_values(cfg)
    jv = jax.tree.map(jnp.asarray, vals)
    params = from_jax_params(tcfg, vals, device="cpu")
    atol = 3e-4 if cfg.rwkv is not None else 2e-5
    B, T = 2, (2 * cfg.sliding_window if cfg.sliding_window else 16)
    S = T + 8
    x = inputs(cfg, B, T + 1)
    prompt, nxt = x[:, :T], x[:, T:T + 1]
    pos = np.full((B,), T, np.int32)
    kw = dict(backend=jb, compute_dtype=jnp.float32)
    tkw = dict(backend=tb, compute_dtype=torch.float32)

    jl, _, jaux = jax_forward(jv, cfg, jnp.asarray(prompt), mode="train",
                              remat=False, **kw)
    tl, _, taux = forward(params, tcfg, torch.from_numpy(prompt),
                          mode="train", **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=atol)

    jc = jax_init_cache(cfg, B, S, jnp.float32)
    jl, jc, _ = jax_forward(jv, cfg, jnp.asarray(prompt), mode="prefill",
                            caches=jc, cache_len=S, **kw)
    tc = init_cache(tcfg, B, S, torch.float32, device="cpu")
    tl, tc, _ = forward(params, tcfg, torch.from_numpy(prompt),
                        mode="prefill", caches=tc, cache_len=S, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=atol)

    jl, _, _ = jax_forward(jv, cfg, jnp.asarray(nxt), mode="decode",
                           caches=jc, pos=jnp.asarray(pos), cache_len=S,
                           **kw)
    tl, _, _ = forward(params, tcfg, torch.from_numpy(nxt), mode="decode",
                       caches=tc, pos=torch.from_numpy(pos), cache_len=S,
                       **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("T", [16, 20, 32, 33])
def test_window_decode_after_prefill_matches_forward(T):
    """A sliding-window prefill of T tokens (window 16 here, T % 16 in
    {0, 4, 0, 1}) then three decoded tokens: each decode's logits equal
    the port's own full forward over the prompt and the tokens so far, at
    the last position, within the 2e-5 of the attention archs (what the
    T % window == 0 cases meet).  The prefill puts key p in ring slot
    p % window, where decode goes on writing; the reference's prefill
    puts the window's keys from slot 0, so its decode evicts the wrong
    key when T % window != 0."""
    arch = "h2o-danube-3-4b"
    cfg, tcfg = reduced_cfgs(arch)
    assert tcfg.sliding_window == 16
    params = from_jax_params(tcfg, noisy_values(cfg), device="cpu")
    B, steps = 2, 3
    S = T + steps
    x = torch.from_numpy(inputs(cfg, B, T + steps, seed=T))
    kw = dict(backend="auto", compute_dtype=torch.float32)
    tc = init_cache(tcfg, B, S, torch.float32, device="cpu")
    _, tc, _ = forward(params, tcfg, x[:, :T], mode="prefill", caches=tc,
                       cache_len=S, **kw)
    for t in range(T, T + steps):
        pos = torch.full((B,), t, dtype=torch.int32)
        got, tc, _ = forward(params, tcfg, x[:, t:t + 1], mode="decode",
                             caches=tc, pos=pos, cache_len=S, **kw)
        full, _, _ = forward(params, tcfg, x[:, :t + 1], mode="train",
                             **kw)
        np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-1.6b", JAMBA,
                                  "deepseek-moe-16b"])
def test_init_params_shapes_and_distributions(arch):
    """The port's init gives the JAX tree's shapes (layer by layer) and its
    distributions: zeros where JAX has zeros, a truncated normal within
    2 * 1/sqrt(fan_in) for dense weights (the expert weights' fan-in is
    E * d, as JAX counts it), and Jamba's Mamba inits."""
    cfg, tcfg = reduced_cfgs(arch)
    values, _ = split_tree(jax_init_params(jax.random.PRNGKey(0), cfg))
    params = init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    ref = from_jax_params(tcfg, jax.tree.map(np.asarray, values),
                          device="cpu")
    got = dict(params.named_parameters())
    exp = dict(ref.named_parameters())
    assert got.keys() == exp.keys()
    for name, t in got.items():
        assert t.shape == exp[name].shape, name
        assert not t.requires_grad
        if not exp[name].any():
            assert not t.any(), name
    assert param_count(params) == sum(
        int(np.prod(np.shape(a))) for a in jax.tree.leaves(values))
    dense = {"rwkv6-1.6b": "blocks.0.rwkv_tm.wr",
             JAMBA: "blocks.0.mamba.in_proj"}.get(arch, "blocks.0.attn.wq")
    moe = [n for n in got if ".moe.wi_" in n or n.endswith(".moe.wo")]
    for name in [dense] + moe:
        w = got[name]
        fan_in = int(np.prod(w.shape[:-1]))
        assert float(w.abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-7, name
        assert float(w.std()) > 0.5 / fan_in ** 0.5, name
    assert bool(moe) == (cfg.moe is not None)
    if arch != JAMBA:
        return
    mam = [n[:-len(".A_log")] for n in got if n.endswith(".mamba.A_log")]
    assert len(mam) == 7  # every layer of the unit but the attention one
    N = cfg.mamba.d_state
    for m in mam:
        torch.testing.assert_close(
            got[f"{m}.A_log"], torch.log(torch.arange(1.0, N + 1)).expand(
                2 * cfg.d_model, N), rtol=0, atol=0)
        assert bool((got[f"{m}.D"] == 1).all())
        dt = torch.nn.functional.softplus(got[f"{m}.dt_bias"])
        assert 1e-3 * (1 - 1e-5) <= float(dt.min())
        assert float(dt.max()) <= 0.1 * (1 + 1e-5)
        conv_w = got[f"{m}.conv_w"]
        assert 0.07 < float(conv_w.std()) < 0.13
        assert float(conv_w.abs().max()) > 0.2  # a plain, untruncated normal
