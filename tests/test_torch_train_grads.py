"""repro_torch's loss and gradients vs the JAX package's, on the CPU:
``loss_fn`` (the MoE aux loss included) and every parameter's gradient
against ``jax.value_and_grad`` on the reduced qwen2-7b (dense),
qwen2-moe-a2.7b (MoE), rwkv6-1.6b and Jamba (Mamba + MoE, one 8-layer
unit), at the JAX default bf16 compute and at f32.

Weights are the JAX init's value tree with seeded numpy noise on every
leaf (``test_torch_models.noisy_values``), loaded with
``from_jax_params``; tokens and labels are seeded numpy.  Both packages
train through their plain paths (``backend="ref"``, the JAX default).
Each arch's JAX gradients are compiled once (two jits) and shared by its
three cases.

Tolerances:
  * f32 compute (a test-local loss over each package's ``forward(...,
    compute_dtype=f32)``): the loss within 2e-5, every gradient leaf
    within 2e-5 relative L2 (measured <= 3.9e-6, Jamba's ``A_log``).
  * bf16 compute (the JAX ``loss_fn`` against the port's ``loss_fn``):
    the loss within 5e-3 (measured <= 2.9e-3, Jamba).  Each gradient
    leaf is held to two limits, both set from the JAX package alone:
      - its relative L2 gap to JAX's bf16 gradient is at most
        ``max(1e-2, 2 * r)``, r being how far bf16 moves JAX's gradient
        from JAX's f32 one.  Two bf16 programs that round in other places
        differ by about r: one bf16 ulp flips an MoE routing choice or a
        near tie.  Measured gap/r <= 0.92 (qwen2-7b), 0.62 (qwen2-moe),
        0.85 (rwkv6), 1.50 (Jamba, a Mamba ``A_log``); the MoE routers,
        which a flipped routing choice moves most (r up to 0.27), read
        <= 1.02, so they need no wider limit;
      - its norm is within ``NORM_TOL`` of JAX's: 0.03 (measured <= 0.011,
        rwkv6's ``mu_w``), 0.055 for Jamba (measured <= 0.043, ``A_log``).
    A planted fault (one leaf's port gradient scaled by 1.1 or by 0.9)
    reads a norm gap >= 0.088 on the other archs and >= 0.061 on Jamba,
    so every leaf's fault is caught (``test_bf16_limits_catch_a_scaled_
    leaf``); a 1.05 or 0.95 scale is caught on the other archs (>= 0.038)
    and not on Jamba, whose bf16 noise is larger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import loss_fn as jax_loss_fn
from repro.models.model import forward as jax_forward
from repro_torch.configs import get_arch
from repro_torch.models import (
    forward, from_jax_params, init_params, loss_fn, to_jax_values,
)
from repro_torch.models.model import nll_loss
from test_torch_models import noisy_values

JAMBA = "jamba-1.5-large-398b"
ARCHS = ["qwen2-7b", "qwen2-moe-a2.7b", "rwkv6-1.6b", JAMBA]
REDUCED = {JAMBA: dict(num_layers=8)}  # one 8-layer unit: a short compile


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_loss_f32(values, cfg, tokens, labels, aux_weight=0.01):
    """``repro.models.loss_fn``'s formula over an f32-compute forward."""
    logits, _, aux = jax_forward(values, cfg, tokens, mode="train",
                                 backend="ref", compute_dtype=jnp.float32)
    logits = logits.astype(jnp.float32)
    logz = jax.nn.logsumexp(logits, axis=-1)
    onehot = jax.nn.one_hot(labels, logits.shape[-1], dtype=logits.dtype)
    nll = jnp.mean(logz - jnp.einsum("btv,btv->bt", logits, onehot))
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def port_loss_f32(params, cfg, tokens, labels):
    logits, _, aux = forward(params, cfg, tokens, mode="train",
                             backend="ref", compute_dtype=torch.float32)
    return nll_loss(logits, labels, aux)


NORM_TOL = {JAMBA: 0.055}  # 0.03 for the others


def bf16_violations(arch: str, jg: dict, tg: dict, jg32: dict) -> dict:
    """Leaves whose bf16 gradient in the port breaks the limits of the
    module docstring, which ``jg`` (JAX's bf16 gradients) and ``jg32``
    (JAX's f32 ones) set: {leaf: (gap, limit, norm gap)}."""
    bad = {}
    for k in jg:
        limit = max(1e-2, 2 * rel_l2(jg32[k], jg[k]))
        gap = rel_l2(jg[k], tg[k])
        norm_gap = abs(np.linalg.norm(np.asarray(tg[k], np.float64))
                       / np.linalg.norm(np.asarray(jg[k], np.float64)) - 1)
        if not (gap <= limit and norm_gap <= NORM_TOL.get(arch, 0.03)):
            bad[k] = (gap, limit, norm_gap)
    return bad


_GRADS: dict = {}


def grads_of(arch: str) -> dict:
    """Per compute type, (loss, aux, gradient leaves) of both packages on
    one seeded batch (computed once per arch: the JAX compiles dominate)."""
    if arch in _GRADS:
        return _GRADS[arch]
    kw = REDUCED.get(arch, {})
    jcfg, tcfg = jax_arch(arch).reduced(**kw), get_arch(arch).reduced(**kw)
    vals = noisy_values(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    out = {}
    for dtype, jf, tf in (("bf16", jax_loss_fn, loss_fn),
                          ("f32", jax_loss_f32, port_loss_f32)):
        f = jax.jit(jax.value_and_grad(
            lambda v, t, l: jf(v, jcfg, t, l), has_aux=True))
        (jl, jm), jg = f(vals, jnp.asarray(toks), jnp.asarray(labs))
        params = from_jax_params(tcfg, vals, device="cpu")
        params.requires_grad_(True)
        tl, tm = tf(params, tcfg, torch.from_numpy(toks),
                    torch.from_numpy(labs))
        tl.backward()
        tg = to_jax_values(tcfg, {n: p.grad
                                  for n, p in params.named_parameters()})
        out[dtype] = {"jax": (float(jl), float(jm["aux"]), leaves(jg)),
                      "port": (float(tl.detach()), float(tm["aux"].detach()),
                               leaves(tg))}
    _GRADS[arch] = out
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_and_grads_match_jax(arch, dtype):
    """The port's loss and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX loss (the MoE aux loss included)."""
    g = grads_of(arch)
    (jl, jaux, jg), (tl, taux, tg) = g[dtype]["jax"], g[dtype]["port"]
    assert jg.keys() == tg.keys()
    if "moe" in arch or arch == JAMBA:
        assert jaux > 0 and taux > 0
    if dtype == "f32":
        assert abs(jl - tl) <= 2e-5 and abs(jaux - taux) <= 2e-5, (jl, tl)
        bad = {k: rel_l2(jg[k], tg[k]) for k in jg}
        bad = {k: e for k, e in bad.items() if not e <= 2e-5}
        assert not bad, bad
        return
    assert abs(jl - tl) <= 5e-3, (jl, tl)
    bad = bf16_violations(arch, jg, tg, g["f32"]["jax"][2])
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_limits_catch_a_scaled_leaf(arch):
    """The bf16 limits sit between the sound readings and a planted
    fault: the port's gradient of any one leaf scaled by 1.1 or by 0.9
    breaks them."""
    g = grads_of(arch)
    jg, tg, jg32 = g["bf16"]["jax"][2], g["bf16"]["port"][2], \
        g["f32"]["jax"][2]
    missed = [(k, s) for k in jg for s in (1.1, 0.9)
              if not bf16_violations(arch, jg, {**tg, k: s * tg[k]}, jg32)]
    assert not missed, missed


def test_remat_gives_the_same_gradients():
    """``remat`` (one checkpointed segment per scan unit) recomputes the
    units in backward and changes no gradient bit."""
    cfg = get_arch(JAMBA).reduced(num_layers=8)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    params.requires_grad_(True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    labs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    grads = []
    for remat in (True, False):
        params.zero_grad(set_to_none=True)
        loss, m = loss_fn(params, cfg, toks, labs, remat=remat)
        loss.backward()
        grads.append([p.grad.clone() for p in params.parameters()])
        assert float(m["aux"].detach()) > 0
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_forward_returns_the_aux_loss():
    """``forward`` returns (logits, caches, aux) in every mode, as the JAX
    version: the MoE aux loss in f32, 0 without MoE layers."""
    toks = torch.zeros((1, 4), dtype=torch.long)
    for arch in ("qwen2-moe-a2.7b", "qwen2-7b"):
        cfg = get_arch(arch).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        logits, caches, aux = forward(params, cfg, toks, mode="train")
        assert caches is None and aux.dtype == torch.float32
        assert logits.shape == (1, 4, cfg.vocab_size)
        assert (float(aux) > 0) == (arch == "qwen2-moe-a2.7b")
