"""The bf16 tolerance of ``flash_attention`` (``ref.mha_tolerance``), held
on the CPU against a plain-torch emulation of the bf16 kernel's arithmetic.

On the card the bf16 kernel runs both products on the tensor cores: the
scores S = Q K^T from bf16 inputs into f32, an online softmax in f32 over
tiles of 128 keys, the probabilities P rounded to bf16 for O += P V (the
row sum l from the unrounded f32 p), the output rounded to bf16.  Rounding
each term p_j v_j moves O by up to 2^-8 sum_j p_j |v_j| / l, which can be
far above 2^-8 |O| when the terms cancel, so the output-rounding rule
alone (2e-4 + 2^-8 |ref|) does not hold for such a kernel while the
term-size rule does.  ``emulate_bf16_flash`` repeats that arithmetic;
here it is held against ``mha_ref`` in f64 at every shape the CUDA tests
use, and against the Pallas kernel (interpret mode) where it takes the
shape, within the bound the card's tests and ``chip_smoke.py`` apply.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ref as tref
from test_torch_lm_kernels import FLASH_CASES, _attn_inputs

KEYS = 128  # keys per tile of the bf16 kernel
LONG_CASE = (1, 1024, 1024, 8, 1, 128, None, 0)


def emulate_bf16_flash(q, k, v, causal=True, window=None, q_offset=0):
    """The bf16 kernel's arithmetic in plain torch: q [B, Tq, Hq, D] and
    k/v [B, Tk, Hkv, D] f32 tensors holding bf16 values -> the output's
    bf16 values as f32."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4)  # b h g t d
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # b h s d
    scale_log2 = torch.tensor(D ** -0.5 * math.log2(math.e),
                              dtype=torch.float32)
    m = torch.full((B, Hkv, G, Tq), float("-inf"))
    l = torch.zeros((B, Hkv, G, Tq))
    o = torch.zeros((B, Hkv, G, Tq, D))
    qpos = torch.arange(Tq)[:, None] + q_offset
    for k0 in range(0, Tk, KEYS):
        ks, vs = kh[:, :, k0:k0 + KEYS], vh[:, :, k0:k0 + KEYS]
        s = torch.einsum("bhgtd,bhsd->bhgts", qg, ks)
        kpos = k0 + torch.arange(ks.shape[2])[None, :]
        ok = torch.ones((Tq, ks.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * scale_log2 - base[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgts,bhsd->bhgtd",
                          p.to(torch.bfloat16).float(), vs)
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / l.clamp(min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, D)
    return out.to(torch.bfloat16).float()


def _bf16_inputs(B, Tq, Tk, Hq, Hkv, D, seed):
    """Seeded normal inputs rounded to bf16 values, held in f32."""
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float()
                 for a in _attn_inputs(B, Tq, Tk, Hq, Hkv, D, seed=seed))


def _ref64(q, k, v, **kw):
    """-> (mha_ref, mha_ref on |v|) in f64 on the same inputs."""
    q, k, v = (a.double() for a in (q, k, v))
    return (tref.mha_ref(q, k, v, **kw), tref.mha_ref(q, k, v.abs(), **kw))


def _emulation_errors(case):
    """-> (|emulation - reference|, exp, exp_abs) in f64 at ``case``."""
    B, Tq, Tk, Hq, Hkv, D, window, q_offset = case
    q, k, v = _bf16_inputs(B, Tq, Tk, Hq, Hkv, D, seed=Tq + D)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = emulate_bf16_flash(q, k, v, **kw).double()
    exp, exp_abs = _ref64(q, k, v, **kw)
    return (got - exp).abs(), exp, exp_abs


@pytest.mark.parametrize("case", FLASH_CASES + [LONG_CASE])
def test_bf16_emulation_within_mha_tolerance(case):
    """Every element of the emulated kernel lies within ``mha_tolerance``
    of the f64 reference, at every CUDA test shape and at 1,024 x 1,024."""
    err, exp, exp_abs = _emulation_errors(case)
    tol = tref.mha_tolerance(exp, exp_abs, torch.bfloat16)
    assert bool((err <= tol).all()), float((err - tol).max())


def test_output_rounding_rule_alone_fails_for_bf16_p():
    """The term-size part of ``mha_tolerance`` is needed: with P rounded
    to bf16, some elements miss 2e-4 + 2^-8 |ref| (the old bf16 rule)."""
    err, exp, _ = _emulation_errors(LONG_CASE)
    assert bool((err > 2e-4 + 2.0 ** -8 * exp.abs()).any())


@pytest.mark.parametrize("case", [(2, 64, 64, 4, 4, 16, None, 0),
                                  (1, 128, 128, 4, 2, 64, 48, 0)])
def test_bf16_emulation_matches_pallas(case):
    """Where the Pallas kernel takes the shape (Tq, Tk multiples of its
    16 x 16 blocks, interpret mode), it and the emulation agree on the
    same bf16-valued inputs in f32 within the same bound."""
    B, Tq, Tk, Hq, Hkv, D, window, q_offset = case
    q, k, v = _bf16_inputs(B, Tq, Tk, Hq, Hkv, D, seed=Tq + D)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = emulate_bf16_flash(q, k, v, **kw).double()
    pal = pallas_flash(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                       block_q=16, block_k=16, interpret=True, **kw)
    pal = torch.from_numpy(np.array(pal)).double()
    _, exp_abs = _ref64(q, k, v, **kw)
    tol = tref.mha_tolerance(pal, exp_abs, torch.bfloat16)
    err = (got - pal).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


if __name__ == "__main__":
    # the numbers behind mha_tolerance: per case, the share of elements
    # outside the output-rounding rule alone, the largest error, and the
    # largest error as a share of mha_tolerance
    for case in FLASH_CASES + [LONG_CASE]:
        err, exp, exp_abs = _emulation_errors(case)
        old = 2e-4 + 2.0 ** -8 * exp.abs()
        tol = tref.mha_tolerance(exp, exp_abs, torch.bfloat16)
        print(case, f"outside 2e-4 + 2^-8|ref|: "
              f"{float((err > old).double().mean()):.4f}, max err "
              f"{float(err.max()):.2e}, max err / mha_tolerance "
              f"{float((err / tol).max()):.3f}")
