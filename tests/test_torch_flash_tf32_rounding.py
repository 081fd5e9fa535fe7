"""The f32 ``flash_attention`` kernel's 3xTF32 arithmetic, held on the CPU
against the unchanged f32 rule (2e-4, ``ref.mha_tolerance`` for f32).

On the card the f32 kernel runs both products on the tensor cores in
TF32, which keeps 10 of f32's 23 mantissa bits.  Each operand x is split
as hi = x rounded to TF32 (to nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and lo = x - hi (exact in f32), which the tensor
cores read to its top 19 bits (Q's and P's, split in registers) or which
is rounded to TF32 in turn (K's and V's, split by a pre-pass); a product
a . b is taken as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), the small
terms first: an error of about 2^-21 relative where TF32 alone
(hi(a) hi(b)) gives 2^-11.  The
kernel takes scores S = Q K^T that way, an online softmax in f32 over
tiles of 64 keys in log2 units, and O += P V that way with P split like
the inputs (the row sum l from the unsplit p).  ``emulate_tf32_flash``
repeats that arithmetic with the number of terms of each product as a
parameter; here the 3-term form is held within 2e-4 of ``mha_ref`` in
f64 at every shape the CUDA tests use and at 1,024 x 1,024, and against
the Pallas kernel (interpret mode) where it takes the shape, and TF32
alone on either product is shown to miss the rule.

    python tests/test_torch_flash_tf32_rounding.py

prints, per case, the largest error of each combination of terms.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ref as tref
from test_torch_lm_kernels import FLASH_CASES, _attn_inputs

KEYS = 64  # keys per tile of the f32 kernel
LONG_CASE = (1, 1024, 1024, 8, 1, 128, None, 0)
RULE = 2e-4  # ref.mha_tolerance for f32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits; to nearest, ties away from
    zero): add half of the 13 dropped bits' unit to the magnitude, then
    clear them."""
    return ((x.view(torch.int32) + 4096) & -8192).view(torch.float32)


def top19(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand in TF32: its top 19
    bits (the low 13 cleared)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def split(x: torch.Tensor, round_lo: bool) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """-> (hi, lo) as the cores read them: hi = TF32 of x, lo = x - hi
    rounded to TF32 or read to its top 19 bits."""
    hi = tf32(x)
    return hi, (tf32 if round_lo else top19)(x - hi)


def product(eq: str, a: torch.Tensor, b: torch.Tensor,
            terms: int) -> torch.Tensor:
    """einsum ``eq`` on the tensor cores, a split in registers (Q or P),
    b by the pre-pass (K or V); f32 sums, the small terms first: 1 term
    = TF32 alone (hi(a) hi(b)), 2 = hi(a) lo(b) + hi(a) hi(b), 3 =
    lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b)."""
    a_hi, a_lo = split(a, round_lo=False)
    b_hi, b_lo = split(b, round_lo=True)
    out = torch.zeros(())
    if terms >= 3:
        out = out + torch.einsum(eq, a_lo, b_hi)
    if terms >= 2:
        out = out + torch.einsum(eq, a_hi, b_lo)
    return out + torch.einsum(eq, a_hi, b_hi)


def emulate_tf32_flash(q, k, v, causal=True, window=None, q_offset=0,
                       terms_s=3, terms_pv=3):
    """The f32 kernel's arithmetic in plain torch: q [B, Tq, Hq, D] and
    k/v [B, Tk, Hkv, D] f32 -> the f32 output."""
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
        s = product("bhgtd,bhsd->bhgts", qg, ks, terms_s)
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
        o = o * alpha[..., None] + product("bhgts,bhsd->bhgtd", p, vs,
                                           terms_pv)
        m = m_new
    out = o / l.clamp(min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, D)


def _error(case, **terms):
    """-> max |emulation - mha_ref in f64| at ``case``."""
    B, Tq, Tk, Hq, Hkv, D, window, q_offset = case
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(
        B, Tq, Tk, Hq, Hkv, D, seed=Tq + D))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = emulate_tf32_flash(q, k, v, **kw, **terms).double()
    exp = tref.mha_ref(q.double(), k.double(), v.double(), **kw)
    return float((got - exp).abs().max())


@pytest.mark.parametrize("case", FLASH_CASES + [LONG_CASE])
def test_3xtf32_emulation_within_f32_rule(case):
    """Every element of the emulated kernel lies within 2e-4 of the f64
    reference, at every CUDA test shape and at 1,024 x 1,024."""
    assert _error(case) <= RULE


@pytest.mark.parametrize("terms", [dict(terms_s=1), dict(terms_pv=1)],
                         ids=["scores", "pv"])
def test_tf32_alone_misses_f32_rule(terms):
    """The split is needed on each product: TF32 alone on the scores, or
    alone on P V, misses 2e-4 at the long case."""
    assert _error(LONG_CASE, **terms) > RULE


@pytest.mark.parametrize("case", [(2, 64, 64, 4, 4, 16, None, 0),
                                  (1, 128, 128, 4, 2, 64, 48, 0)])
def test_3xtf32_emulation_matches_pallas(case):
    """Where the Pallas kernel takes the shape (Tq, Tk multiples of its
    16 x 16 blocks, interpret mode), it and the emulation agree within
    the f32 rule on the same inputs."""
    B, Tq, Tk, Hq, Hkv, D, window, q_offset = case
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(
        B, Tq, Tk, Hq, Hkv, D, seed=Tq + D))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = emulate_tf32_flash(q, k, v, **kw)
    pal = pallas_flash(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                       block_q=16, block_k=16, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=0,
                               atol=RULE)


if __name__ == "__main__":
    # the numbers behind the choice of terms: per case, the largest error
    # against mha_ref in f64 for each combination
    combos = [(1, 1), (1, 3), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]
    for case in FLASH_CASES + [LONG_CASE]:
        errs = ", ".join(
            f"S{s}/PV{p} {_error(case, terms_s=s, terms_pv=p):.2e}"
            for s, p in combos)
        print(case, errs)
