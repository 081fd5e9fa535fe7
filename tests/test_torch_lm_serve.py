"""repro_torch ``LMServer`` vs the JAX package's, reduced qwen2-7b,
rwkv6-1.6b and jamba-1.5-large (one 8-layer unit: Mamba and MoE layers,
the Mamba states carried through decode) on the CPU, from the same noisy
weights (every leaf, the zero-initialised ones too, gets seeded noise).

Greedy tokens must be equal; the prefill's last-position logits agree
within 1e-4 absolute (max |logit| ~3; measured <= 2.5e-6, though the plain
WKV paths differ: the JAX server's default ``backend="ref"`` runs the
chunked closed form, the port's ``"auto"`` on CPU tensors the step
recurrence); ``embed`` within 1e-6 absolute (a softmax-weighted mean of
embedding rows, entries ~0.015; measured 1.5e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import LMServer as JaxLMServer
from repro_torch.configs import get_arch
from repro_torch.models import from_jax_params, init_params
from repro_torch.serve import LMServer

from test_torch_models import noisy_values, reduced_cfgs

ARCHS = ["qwen2-7b", "rwkv6-1.6b", "jamba-1.5-large-398b"]


def _servers(arch: str, max_len: int):
    cfg, tcfg = reduced_cfgs(arch)
    vals = noisy_values(cfg, seed=2)
    jserver = JaxLMServer(cfg, jax.tree.map(jnp.asarray, vals),
                          max_len=max_len, compute_dtype=jnp.float32)
    tserver = LMServer(tcfg, from_jax_params(tcfg, vals, device="cpu"),
                       max_len=max_len, device="cpu")
    return cfg, jserver, tserver


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    B, T, steps = 3, 16, 6
    cfg, jserver, tserver = _servers(arch, T + steps)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    want = jserver.generate(prompts, steps=steps)
    got = tserver.generate(prompts, steps=steps)
    np.testing.assert_array_equal(got, want)
    jlogits, _ = jserver._prefill(jserver.values, jnp.asarray(prompts))
    np.testing.assert_allclose(
        tserver.last_run["prefill_logits"].numpy(), np.asarray(jlogits),
        rtol=0, atol=1e-4)
    run = tserver.last_run
    assert run["margins"].shape == (B, steps)
    assert (run["margins"] >= 0).all() and run["decode_steps"] == steps - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_matches_jax(arch):
    cfg, jserver, tserver = _servers(arch, 32)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    got = tserver.embed(toks)
    assert got.shape == (2, cfg.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, jserver.embed(toks), rtol=0, atol=1e-6)


def test_temperature_sampling_is_seeded():
    cfg = get_arch("qwen2-7b").reduced()
    server = LMServer(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu"),
                      max_len=24, device="cpu")
    prompts = np.arange(16, dtype=np.int32).reshape(2, 8)
    a = server.generate(prompts, steps=5, temperature=0.8, seed=3)
    b = server.generate(prompts, steps=5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and ((a >= 0) & (a < cfg.vocab_size)).all()


def test_lm_server_defaults_to_the_card(monkeypatch):
    """``device=None`` means CUDA, and raises where there is none (no CPU
    fallback)."""
    cfg = get_arch("qwen2-7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMServer(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())
