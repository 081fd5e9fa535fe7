"""The tuning knobs that change numbers, port vs JAX, on the CPU:
``tp_reduce_dtype="bfloat16"`` (the row-parallel products rounded to
bf16, the JAX ``rp_einsum``) and ``moe_shard_dispatch=True`` (the 2-D
gather dispatch, with ``moe_expert_axis`` "model" and "data"), each
against JAX ``forward`` under the same knob, on the reduced qwen2-7b and
qwen2-moe-a2.7b with seeded noisy weights (``test_torch_models``).

The JAX side runs inside a one-device ``(data, model)`` mesh: its
``moe2d`` path pins buffers with ``with_sharding_constraint``, which
needs one.  Tolerances, on train-mode logits at f32 compute:
  * ``moe_shard_dispatch``: 2e-5 absolute (both sides f32 in another
    order), and the port's 2-D dispatch bitwise its scatter dispatch;
  * ``tp_reduce_dtype``: 5e-5 absolute (max |logit| ~4).  Both sides
    round the same f32 products to bf16 once; a product that the f32
    summation order moves across a rounding boundary lands one bf16 ulp
    away, which the next layers shrink: measured 4.2e-6 (qwen2-7b) and
    1.07e-5 (qwen2-moe).  The knob must matter: it moves JAX's logits by
    0.0128 and 0.271, and the port without it misses JAX with it by more
    than 100x the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax forward-compat shims before make_mesh)
from repro.models import forward as jax_forward
from repro.models import tuning as jtuning
from repro_torch.models import forward, from_jax_params
from repro_torch.models import tuning
from test_torch_models import inputs, noisy_values, reduced_cfgs


@pytest.fixture
def knobs():
    """-> set(**kw) on both packages' TUNING; restored afterwards."""
    saved = (dataclasses.asdict(jtuning.TUNING),
             dataclasses.asdict(tuning.TUNING))

    def set_(**kw):
        jtuning.set_tuning(**kw)
        tuning.set_tuning(**kw)

    yield set_
    for obj, vals in zip((jtuning.TUNING, tuning.TUNING), saved):
        for k, v in vals.items():
            setattr(obj, k, v)


def _logits(arch: str, T: int = 16):
    """-> (jax_fn, port_fn): train-mode f32 logits of each package over
    2 x ``T`` tokens."""
    cfg, tcfg = reduced_cfgs(arch)
    vals = noisy_values(cfg)
    jv = jax.tree.map(jnp.asarray, vals)
    params = from_jax_params(tcfg, vals, device="cpu")
    x = inputs(cfg, 2, T)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def jax_fn():
        with jax.set_mesh(mesh):
            out, _, _ = jax_forward(jv, cfg, jnp.asarray(x), mode="train",
                                    backend="ref", remat=False,
                                    compute_dtype=jnp.float32)
        return np.asarray(out)

    def port_fn():
        with torch.no_grad():
            out, _, _ = forward(params, tcfg, torch.from_numpy(x),
                                mode="train", backend="ref",
                                compute_dtype=torch.float32)
        return out.numpy()

    return jax_fn, port_fn


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b"])
def test_tp_reduce_bf16_matches_jax(arch, knobs):
    jax_fn, port_fn = _logits(arch)
    plain = port_fn()
    knobs(tp_reduce_dtype="bfloat16")
    want, got = jax_fn(), port_fn()
    tol = 5e-5
    gap = float(np.abs(got - want).max())
    assert gap <= tol, (gap, tol)
    assert float(np.abs(plain - want).max()) > 100 * tol  # the knob rounds


@pytest.mark.parametrize("axis", ["model", "data"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-7b"])
def test_moe_2d_dispatch_matches_jax(arch, axis, knobs):
    # 128 tokens: capacity 80 slots an expert against 64 on average, so
    # the skewed routing of noisy weights drops tokens (the dump row)
    jax_fn, port_fn = _logits(arch, T=64)
    scatter = port_fn()
    knobs(moe_shard_dispatch=True, moe_expert_axis=axis)
    want, got = jax_fn(), port_fn()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.array_equal(got, scatter)  # the same numbers as the scatter
