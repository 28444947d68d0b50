"""The arithmetic of K7's and K9's tensor-core products, emulated in
torch on the CPU (``csrc/mma_tf32x3.cuh``): each float32 operand is
split into two TF32 values, hi = rna(x) and lo = rna(x - hi), rna
rounding to the nearest value of 10 explicit mantissa bits (ties away
from zero, as ``cvt.rna.tf32.f32``), and a product is the float32 sum of
the three TF32 products lo·hi + hi·lo + hi·hi.

K7's math (scores, online softmax's unnormalised P, P·V) and K9's (C·Bᵀ,
M, y = M·(x dt), the states) run through that product at the models'
widths on inputs from a numpy seed, and are held to the reference
(``repro.kernels.flash_attention.ref.attention_ref``, and the Pallas
``ssd_chunk_kernel`` in interpret mode, as ``tests/test_torch_ssd.py``
runs it) within the unchanged tolerances: ``attention_cases.TOLERANCE``
and ``ssd_cases.tolerance``. The same math with one TF32 product
(hi·hi: ~2^-10 relative per product) misses them: the numerical reason
for the three-term split."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as ref_attention,
)
from repro.kernels.ssd.ssd import ssd_chunk_kernel  # noqa: E402
from repro_torch.kernels import attention_cases as AC  # noqa: E402
from repro_torch.kernels import ssd_cases as SC  # noqa: E402

# (B, H, K, S, d): starcoder2-3b's and hymba-1.5b's attention widths at a
# 128-token admission (hymba's window of 2048 does not cut at S = 128)
ATTN = {"starcoder2-3b": (1, 24, 2, 128, 128),
        "hymba-1.5b": (1, 25, 5, 128, 64)}
# (b, s, h, p, n, chunk): mamba2-370m's and hymba-1.5b's SSD widths
SSD = {"mamba2-370m": (1, 128, 32, 64, 128, 128),
       "hymba-1.5b": (1, 128, 50, 64, 16, 64)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with 10 explicit mantissa bits, ties
    away from zero: add half of the 13 dropped bits to the magnitude
    bits, then clear them (the sign bit is left alone)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the three TF32 products of the split operands, small
    terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product."""
    return round_tf32(a) @ round_tf32(b)


def attention(q, k, v, mm):
    """K7's math over (B, H, S, d) with causal masking: scores, the
    unnormalised P = exp(s - max), P·V, then the division by the row
    sum, each product through ``mm``."""
    B, H, S, d = q.shape
    group = H // k.shape[1]
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = mm(q, kk.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, s, torch.full_like(s, -math.inf))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, vv) / p.sum(-1, keepdim=True)


def ssd_chunk(x, dt, A, B, C, chunk, mm):
    """K9's math (``ssd_chunk_ref``'s) with every product through
    ``mm``: C·Bᵀ, y = (C·Bᵀ ∘ exp(cum_i - cum_j) selected to j <= i)·(x
    dt) per head, states = (exp(cum_last - cum) x dt)ᵀ·B per head."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtc * A, dim=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    L = torch.where(tri[:, :, None], torch.exp(diff), torch.zeros(()))
    M = mm(Cc, Bc.transpose(-1, -2))[..., None] * L  # (b, nc, i, j, h)
    xdt = xc * dtc[..., None]  # (b, nc, l, h, p)
    y = mm(M.permute(0, 1, 4, 2, 3), xdt.permute(0, 1, 3, 2, 4))
    w = torch.exp(cum[:, :, -1:, :] - cum)[..., None] * xdt
    st = mm(w.permute(0, 1, 3, 4, 2), Bc[:, :, None])  # (b, nc, h, p, n)
    return (y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), st,
            torch.exp(cum[:, :, -1, :]), cum.reshape(b, s, h))


def attention_error(name, mm):
    B, H, K, S, d = ATTN[name]
    rng = np.random.default_rng(S + d + H)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((B, H, S, d), (B, K, S, d), (B, K, S, d)))
    want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True))
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), mm)
    return float(np.abs(got.numpy() - want).max())


def ssd_inputs(name, strong):
    """x, dt, A, B, C as numpy float32: ``strong`` draws them as
    ``ssd_cases`` does (dt = softplus(3 N), A = -U[1, 16], the model's
    init: exp above the diagonal overflows), else dt = softplus(N) and
    A = -exp(N / 2)."""
    b, s, h, p, n, _ = SSD[name]
    rng = np.random.default_rng(s + h + n + int(strong))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    z = rng.standard_normal((b, s, h)) * (3.0 if strong else 1.0)
    dt = np.log1p(np.exp(z)).astype(np.float32)
    A = (-rng.uniform(1.0, 16.0, h) if strong
         else -np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def ssd_over_allowance(name, strong, mm):
    """The worst max|emulated - reference| of the four outputs over its
    allowance, ``ssd_cases.tolerance`` of max(1, max|reference|)."""
    chunk = SSD[name][-1]
    args = ssd_inputs(name, strong)
    want = ssd_chunk_kernel(*(jnp.asarray(a) for a in args), chunk=chunk,
                            interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    got = ssd_chunk(*targs, chunk, mm)
    tol = SC.tolerance(SC.cum_max(targs[1], targs[2], chunk))
    worst = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = float(np.abs(g.numpy() - w).max())
        worst = max(worst, err / (tol * max(1.0, float(np.abs(w).max()))))
    return worst


def test_split_represents_float32_to_2_22():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(4096) * 1e4,
        rng.standard_normal(4096) * 1e-4]).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):  # TF32 values: 13 low mantissa bits clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0**-11
    assert float(((x - (hi + lo)).abs() / x.abs()).max()) <= 2.0**-22
    # ties away from zero, as cvt.rna: 1 + 2^-11 lies halfway
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
    assert round_tf32(tie).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


@pytest.mark.parametrize("name", list(ATTN))
def test_attention_three_tf32_products_meet_the_tolerance(name):
    err = attention_error(name, mm_tf32x3)
    assert err <= AC.TOLERANCE, err


@pytest.mark.parametrize("name", list(ATTN))
def test_attention_one_tf32_product_misses_the_tolerance(name):
    err = attention_error(name, mm_tf32)
    assert err > AC.TOLERANCE, err


@pytest.mark.parametrize("strong", (False, True), ids=("mild", "strong"))
@pytest.mark.parametrize("name", list(SSD))
def test_ssd_three_tf32_products_meet_the_tolerance(name, strong):
    worst = ssd_over_allowance(name, strong, mm_tf32x3)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("strong", (False, True), ids=("mild", "strong"))
@pytest.mark.parametrize("name", list(SSD))
def test_ssd_one_tf32_product_misses_the_tolerance(name, strong):
    worst = ssd_over_allowance(name, strong, mm_tf32)
    assert worst > 1.0, worst
