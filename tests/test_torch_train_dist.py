"""repro_torch's training collectives on four ``torch.distributed`` ranks
(spawned on the CPU by ``tests/_torch_ranks.py``, gloo, one spawn for
every case) against the JAX package's.

* ``compressed_psum``: every rank's int8 payload equals the JAX
  reduction's for the same inputs (the JAX ``compressed_psum`` runs under
  ``jax.vmap`` with the axis name, which gives ``pmax``/``psum`` their
  mesh-axis meaning on one device; its payload is recovered exactly from
  its residual, ``round((g - new_err) / scale)``), and so do the mean and
  the residual, bit for bit; over 50 steps with error feedback the mean
  of the reductions is the true mean within 2e-2
  (``tests/test_elastic_compress.py``'s bound).
* ``make_gpipe`` (S 4 stages, M 6 microbatches of 3, d 16): every rank
  returns the sequential composition of the stages within 2e-5
  (``tests/test_sharding_distributed.py``'s bound), and the JAX package's
  sequential composition too; on a 2 x 2 ``(pod, data)`` mesh every rank
  returns the composition of the first two stages (each data column is a
  pipeline of its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks, train_ranks
from repro.train.compress import compressed_psum as jax_compressed_psum

WORLD = 4
S, M, MB, D = 4, 6, 3, 16
STEPS = 50


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((WORLD, 64)) * np.array(
        [[1.0], [0.3], [2.5], [0.01]])).astype(np.float32)
    e = (0.01 * rng.standard_normal((WORLD, 64))).astype(np.float32)
    ws = (0.5 * rng.standard_normal((S, D, D))).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return g, e, ws, xs


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    g, e, ws, xs = inputs
    return run_ranks(train_ranks, WORLD, tmp_path_factory.mktemp("tr4"),
                     g, e, STEPS, ws, xs)


def test_compressed_psum_matches_jax(inputs, ranks):
    g, e, _, _ = inputs

    def f(g, e):
        out, new_e = jax_compressed_psum({"w": g}, {"w": e}, "pod")
        return out["w"], new_e["w"]

    jout, jerr = jax.vmap(f, axis_name="pod")(jnp.asarray(g), jnp.asarray(e))
    jout, jerr = np.asarray(jout), np.asarray(jerr)
    g32 = g + e
    scale = np.float32(max(np.abs(g32).max(), 1e-12)) / np.float32(127.0)
    for r, res in enumerate(ranks):
        assert np.float32(res["scale"]) == scale
        jq = np.round((g32[r].astype(np.float64) - jerr[r]) / scale)
        np.testing.assert_array_equal(res["q"].astype(np.float64), jq)
        np.testing.assert_array_equal(res["out"], jout[r])
        np.testing.assert_array_equal(res["new_e"], jerr[r])
    np.testing.assert_allclose(ranks[0]["out"], (g + e).mean(0), atol=0.02)


def test_compressed_psum_unbiased_over_steps(inputs, ranks):
    g = inputs[0]
    for res in ranks:
        np.testing.assert_allclose(res["ef_mean"], g.mean(0), atol=2e-2)


def test_gpipe_matches_sequential(inputs, ranks):
    _, _, ws, xs = inputs
    exp = torch.from_numpy(xs)
    jexp = jnp.asarray(xs)
    for s in range(S):
        exp = torch.tanh(exp @ torch.from_numpy(ws[s]))
        jexp = jnp.tanh(jexp @ jnp.asarray(ws[s]))
        if s == 1:
            exp2 = exp.numpy()
    for res in ranks:
        np.testing.assert_allclose(res["gpipe"], exp.numpy(), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(res["gpipe"], np.asarray(jexp),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(res["gpipe_2x2"], exp2, rtol=2e-5,
                                   atol=2e-5)
