"""The sweep that holds K9 (the SSD intra-chunk step) to its plain
version on the card, and its tolerance: one copy for the card tests and
for ``chip_smoke.py``.

Inputs follow the model's own distribution where it is hardest:
dt = softplus(3 N(0, 1)) and A = -U[1, 16] (``init_params``' A_log),
so dt·A reaches -250 a step, |cum| reaches ~10^4 within a chunk and
exp(cum_i - cum_j) above the diagonal overflows to inf (it must be
selected away, never multiplied by 0). x, B and C are unit normals,
laid out as the model passes them: strided slices of one
(b, s, h·p + 2n) buffer, the conv output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNKS = (64, 128)
# (h, p, n): one head; mamba2-370m's 32 x 64 with state 128; hymba-1.5b's
# 50 x 64 with state 16
HPN = ((1, 16, 16), (32, 64, 128), (50, 64, 16))
BATCHES = (1, 16)
# one model-mesh position's rows of a full 16 x 128 admission: mamba2-370m
# at (2, 2) (8 rows a data rank), hymba-1.5b at (2, 1) and at (2, 2)
# under dp_over_tp (4 rows), (b, s, h, p, n, chunk)
MESH_CASES = ((8, 128, 32, 64, 128, 128), (8, 128, 50, 64, 16, 64),
              (4, 128, 50, 64, 16, 64))
# the whole SSD (ops.ssd) against the sequential oracle: (b, s, h, p, n,
# chunk)
ORACLE_CASE = (1, 1000, 4, 16, 16, 128)
# float32 sums over <= 128 terms taken in another order than the plain
# version's
BASE_TOLERANCE = 1e-5


def seq_lens(chunk: int) -> tuple[int, ...]:
    """Sequence lengths around one chunk and past four."""
    return (1, chunk - 1, chunk, chunk + 1, 4 * chunk + 3)


def sweep():
    """Every (b, s, h, p, n, chunk) of the K9 sweep."""
    return [(b, s, h, p, n, chunk) for chunk in CHUNKS
            for s in seq_lens(chunk) for (h, p, n) in HPN
            for b in BATCHES]


def tolerance(cum_max: float) -> float:
    """Largest max|kernel - plain| allowed, relative to max(1, max|plain|)
    of each output. The decay weights exp(cum_i - cum_j) carry the
    rounding of cum: where the two versions sum dt·A in different orders
    each cum is off by a few ulps of its magnitude (2^-24 cum_max), and
    the weights by that much relatively; the rest is BASE_TOLERANCE."""
    return BASE_TOLERANCE + 2.0**-23 * cum_max


def cum_max(dt: torch.Tensor, A: torch.Tensor, chunk: int) -> float:
    """max |cum| over the in-chunk prefix sums of dt·A (dt padded to a
    multiple of ``chunk``)."""
    b, s, h = dt.shape
    S = s + (-s) % chunk
    d = F.pad(dt.float(), (0, 0, 0, S - s)) * A.float()
    return float(d.reshape(b, S // chunk, chunk, h).cumsum(2).abs().max())


def case_inputs(b: int, s: int, h: int, p: int, n: int, chunk: int,
                generator: torch.Generator, device):
    """x (b, S, h, p), dt (b, S, h), A (h,), B and C (b, S, n) with S
    the next multiple of ``chunk``, padded as ``ops.ssd`` pads (dt = 0
    steps, zero input); x, B and C are strided views of one buffer."""
    S = s + (-s) % chunk
    g = dict(generator=generator, device=device)
    buf = F.pad(torch.randn(b, s, h * p + 2 * n, **g), (0, 0, 0, S - s))
    x = buf[..., :h * p].reshape(b, S, h, p)
    B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    dt = F.pad(F.softplus(torch.randn(b, s, h, **g) * 3.0),
               (0, 0, 0, S - s))
    A = -(torch.rand(h, **g) * 15.0 + 1.0)
    return x, dt, A, B, C


def oracle_inputs(generator: torch.Generator, device, case=ORACLE_CASE):
    """The inputs of ``case`` (b, s, h, p, n, chunk), unpadded and
    contiguous, from the same distribution."""
    b, s, h, p, n, _ = case
    g = dict(generator=generator, device=device)
    x = torch.randn(b, s, h, p, **g)
    dt = F.softplus(torch.randn(b, s, h, **g) * 3.0)
    A = -(torch.rand(h, **g) * 15.0 + 1.0)
    return x, dt, A, torch.randn(b, s, n, **g), torch.randn(b, s, n, **g)
