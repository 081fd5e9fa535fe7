"""The ``mamba_scan`` kernel's exponentials, held on the CPU against the
unchanged rule (2e-5 + 2e-5 |ref|, the JAX package's tolerance for the
scan).

On the card the kernel pre-scales A by log2(e) in f32 and takes each
decay as 2^x, x = dt * a', with ``ex2.approx.ftz.f32`` on the SFUs, whose
relative error the PTX ISA bounds by 2^-22, where x <= -kNear, and from a
degree-3 polynomial exact at 0, p(x) = 1 + x q(x), where x > -kNear
(``ex2_guarded``).

The reason: close to 1 an exponential's error that keeps one sign builds
up in h over ~1 / (1 - 2^x) steps.  An SFU error of 2^-22 of one sign
moves a scan whose decays stay close to 1 past the rule (A =
-exp(N(0, 1)) with dt log-uniform on [1e-3, 1e-1], Mamba's dt init:
``test_sfu_alone_misses_rule``); the polynomial's error scales with
1 - 2^x and cannot build up.

``emulate_scan`` repeats the kernel's arithmetic step by step in f32
torch: the pre-scaled product, the SFU exponential as the exact 2^x times
(1 + s 2^-22) with s = +-1 (seeded-random per exponential, or all +1 or
all -1), results below 2^-126 flushed to zero, the polynomial op by op
with the coefficients and the threshold read from ``csrc/mamba_scan.cu``,
then the kernel's order of the h and y FMAs (y summed in 4 partial sums,
n mod 4).  A fused multiply-add is emulated by its exact product in f64
rounded once to f32 after the add (twice, through f64: a 1-ulp difference
in rare ties, far below the rule).  Here the kernel's arithmetic lies
within the rule of an f64 scan at B 2, T 2,048, di 256, N 16, with A as
Mamba initialises it (-(1..N), spread per channel) or -exp(N(0, 1))
(decays much closer to 1), and dt as the smoke draws it (softplus(randn -
1)) or as Mamba's dt init spans it.  The polynomial's own relative error
is held to 2^-23 over the arguments it sees, and it is exact at 0.

    python tests/test_torch_mamba_exp_rounding.py

prints, per draw and route, the largest error as a share of the rule and
the share of exponentials that the polynomial takes.
"""
import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "mamba_scan.cu").read_text()
EX2_REL = 2.0 ** -22  # PTX ISA: ex2.approx.f32, maximum relative error
RULE = 2e-5  # rtol and atol of the scan
SHAPE = (2, 2048, 256, 16)  # B, T, di, N


def _constant(name: str) -> float:
    return float(re.search(rf"constexpr \w+ {name} = ([\d.]+)f?;",
                           SRC).group(1))


def _coefficients(fn: str, count: int) -> list[float]:
    """The hex-float literals of ``fn``'s body in ``mamba_scan.cu``."""
    body = SRC[SRC.index(f"float {fn}(float x)"):]
    body = body[:body.index("return")]
    coeffs = [float.fromhex(c) for c in re.findall(
        r"(0x1\.[0-9a-f]+p-?\d+)f", body)]
    assert len(coeffs) == count, coeffs
    return coeffs


NEAR = _constant("kNear")
NEAR_COEFFS = _coefficients("ex2_guarded", 3)  # c3, c2, c1 (in use order)


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 fused multiply-add: the exact product, one rounding after the
    add (through f64)."""
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b.double() + c).float()


def ex2_near(x: torch.Tensor) -> torch.Tensor:
    """``ex2_guarded``'s polynomial: 1 + x (c1 + x (c2 + x c3)) in f32."""
    c3, c2, c1 = NEAR_COEFFS
    q = fma(x, torch.full_like(x, c3), c2)
    q = fma(q, x, c1)
    return fma(q, x, 1.0)


def ex2_mufu(x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """``ex2.approx.ftz.f32`` at its documented worst case: the exact 2^x
    off by ``sign`` * 2^-22 relative, rounded to f32; results below
    2^-126 flushed to zero."""
    e = (torch.exp2(x.double()) * (1.0 + sign * EX2_REL)).float()
    return torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)


def _signs(mode: str, shape, gen: torch.Generator) -> torch.Tensor:
    if mode == "random":
        return torch.randint(0, 2, shape, generator=gen).double() * 2 - 1
    return torch.full(shape, 1.0 if mode == "plus" else -1.0,
                      dtype=torch.float64)


def emulate_scan(A, dt, Bm, Cm, x, h0, route: str = "kernel",
                 signs: str = "random", seed: int = 0):
    """The kernel's arithmetic in f32 torch -> (y [B, T, di], h_T, the share
    of exponentials taken from the polynomial).  ``route``: "kernel" (the
    SFU guarded close to 1), "sfu" (every exponential on the SFU) or
    "accurate" (f32 ``exp`` of the unscaled product, the first kernel's
    expf)."""
    B, T, di = x.shape
    N = A.shape[1]
    a2 = A * np.float32(math.log2(math.e))  # the pre-scaled A, in f32
    gen = torch.Generator().manual_seed(seed)
    h = h0.clone()
    ys, near = [], 0
    for t in range(T):
        dtv = dt[:, t, :, None]
        dx = dt[:, t] * x[:, t]
        arg = dtv * a2
        if route == "accurate":
            e = torch.exp(dtv * A)
        else:
            e = ex2_mufu(arg, _signs(signs, arg.shape, gen))
            if route == "kernel":
                e = torch.where(arg > -NEAR, ex2_near(arg), e)
        near += int((arg > -NEAR).sum())
        h = fma(e, h, dx[..., None] * Bm[:, t, None, :])
        acc = torch.zeros(B, di, 4)
        for n0 in range(0, N, 4):
            acc = fma(h[..., n0:n0 + 4], Cm[:, t, None, n0:n0 + 4], acc)
        ys.append((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3]))
    return torch.stack(ys, dim=1), h, near / (B * T * di * N)


def scan_f64(A, dt, Bm, Cm, x, h0):
    """The selective scan in f64 (the reference)."""
    A, dt, Bm, Cm, x, h = (a.double() for a in (A, dt, Bm, Cm, x, h0))
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (
            dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


@functools.lru_cache(maxsize=None)
def _case(draw: str):
    """Seeded inputs at SHAPE and their f64 scan.  ``draw`` = "<A>-<dt>":
    A "init" as Mamba initialises it, -(1..N) spread per channel, or
    "lognormal", -exp(N(0, 1)); dt "softplus" as the smoke draws it or
    "loguniform" as Mamba's dt init spans it."""
    a_draw, dt_draw = draw.split("-")
    B, T, di, N = SHAPE
    rng = np.random.default_rng(17)
    if a_draw == "init":
        A = -(np.arange(1, N + 1) * np.exp(0.1 * rng.normal(size=(di, N))))
    else:
        A = -np.exp(rng.normal(size=(di, N)))
    if dt_draw == "softplus":
        dt = np.logaddexp(0.0, rng.normal(size=(B, T, di)) - 1.0)
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, T, di)))
    Bm, Cm = (rng.normal(size=(B, T, N)) for _ in range(2))
    x = rng.normal(size=(B, T, di))
    h0 = rng.normal(size=(B, di, N))
    args = tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (A, dt, Bm, Cm, x, h0))
    return args, scan_f64(*args)


def _share(draw: str, **route) -> tuple[float, float]:
    """-> (the largest |emulation - f64 scan| / (2e-5 + 2e-5 |ref|) over y
    and h_T, the share of exponentials the polynomial takes)."""
    args, ref = _case(draw)
    *got, near = emulate_scan(*args, **route)
    return max(float(((g.double() - r).abs() / (RULE + RULE * r.abs()))
                     .max()) for g, r in zip(got, ref)), near


DRAWS = ["init-softplus", "init-loguniform", "lognormal-softplus",
         "lognormal-loguniform"]
SIGNS = ["random", "plus", "minus"]
ROUTES = {f"kernel-{s}": dict(route="kernel", signs=s) for s in SIGNS}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("draw", DRAWS)
def test_exponential_routes_within_scan_rule(draw, route):
    """The kernel's arithmetic (the SFU at its documented worst error,
    random or one-signed, the polynomial close to 1) keeps y and h_T
    within 2e-5 + 2e-5 |ref| of the f64 scan."""
    assert _share(draw, **ROUTES[route])[0] <= 1.0


def test_sfu_alone_misses_rule():
    """The guard is needed: the SFU for every exponential, with its
    documented error of one sign, misses the rule where decays stay close
    to 1 (A = -exp(N(0, 1)), dt log-uniform on [1e-3, 1e-1])."""
    assert _share("lognormal-loguniform", route="sfu", signs="plus")[0] > 1


def test_near_one_polynomial_error_bound():
    """``ex2_guarded``'s polynomial within 2^-23 relative of 2^x on [-1/8,
    0], where the kernel takes it, and exact at 0."""
    x = torch.linspace(-NEAR, 0.0, 400001, dtype=torch.float64).float()
    exact = torch.exp2(x.double())
    rel = ((ex2_near(x).double() - exact) / exact).abs()
    assert float(rel.max()) <= 2.0 ** -23
    assert float(ex2_near(torch.zeros(1))) == 1.0


if __name__ == "__main__":
    # the numbers behind the route: per draw, the kernel's and the SFU's
    # largest error as a share of the rule, and the polynomial's share of
    # the exponentials
    routes = {**ROUTES,
              **{f"sfu-{s}": dict(route="sfu", signs=s) for s in SIGNS},
              "accurate expf": dict(route="accurate")}
    for draw in DRAWS:
        out = []
        for name, r in routes.items():
            share, near = _share(draw, **r)
            out.append(f"{name} {share:.3f}")
        print(f"{draw} (polynomial {near:.3f}):", ", ".join(out))
