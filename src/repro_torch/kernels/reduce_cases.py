"""The cases that hold K5 (the segmented reduction, one memset and one
launch, ``csrc/segment_reduce.cu``) to its plain version: one copy for
the card tests and for ``chip_smoke.py``.

Sizes around the kernel's batch (``BATCH`` rows a block loads at once):
below one batch, exactly one, five and a ragged tail, and 2^22 + 5
(more batches than one grid holds, so blocks walk several). Segment
counts: 1, the group-by's 120, the radix histograms' 256 and the shared
accumulators' limit and one either side of it (the last takes the
global-atomic path). Every op at both dtypes; ids spread uniformly, hot
(~90% in one segment), sorted, or partly outside [0, G) (dropped).
int32 values span the whole range with the extremes planted; float32
min/max values carry NaNs of several payloads and signs, ±inf, ±0.0,
denormals and ±FLT_MAX (float32 sums take finite values). Views start
``OFFSETS`` elements into a buffer (the scalar instance); a captured
CUDA graph is replayed ``REPLAYS`` times on alternating inputs (each
replay must reset the output and the arrival counter), and two calls run
on two streams at once.

Every case is bit-identical to the plain version (float min/max
compared as bits: the canonical NaN, -0.0 below +0.0) except float32
sums, held to the float32 accumulation bound count * 2^-23 * sum|v|.
"""
from __future__ import annotations

import torch

# rows a block loads at once and the most segments accumulated in shared
# memory: csrc/segment_reduce.cu's kBatch and kSharedMaxSegments,
# exported by the library as repro_segment_reduce_batch() and
# repro_segment_reduce_shared_max()
BATCH = 4096
SHARED_MAX = 12288
SIZES = (1000, BATCH, 5 * BATCH + 3, 2**22 + 5)
SEGMENTS = (1, 120, 256, SHARED_MAX - 1, SHARED_MAX, SHARED_MAX + 1)
OPS = ("sum", "min", "max")
DTYPES = (torch.int32, torch.float32)
ID_KINDS = ("uniform", "hot", "sorted", "outside")
OFFSETS = (1, 2, 3)
REPLAYS = 200
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
# float32 bit patterns planted among the values of min/max cases
SPECIAL_BITS = (0x7fc00000, 0x7f800001, 0x7fffffff, -0x00400000, -1,
                0x7f800000, -0x00800000, 0x00000000, -0x80000000,
                0x00000001, 0x007fffff, -0x7fffffff, -0x7f800001,
                0x7f7fffff, -0x00800001)


def make_values(dtype, n: int, gen: torch.Generator, device,
                finite: bool = False) -> torch.Tensor:
    """(n,) values: int32 over the whole range with both extremes
    planted; float32 ~ 100 N(0, 1) with 5% special bit patterns (none
    with ``finite``)."""
    pick = torch.rand(n, generator=gen, device=device) < 0.05
    if dtype == torch.int32:
        v = torch.randint(INT32_MIN, INT32_MAX, (n,), generator=gen,
                          device=device, dtype=torch.int32)
        ext = torch.where(torch.rand(n, generator=gen, device=device) < 0.5,
                          INT32_MIN, INT32_MAX).to(torch.int32)
        return torch.where(pick, ext, v)
    v = torch.randn(n, generator=gen, device=device) * 100
    if finite:
        return v
    special = torch.tensor(SPECIAL_BITS, dtype=torch.int32,
                           device=device).view(torch.float32)
    which = torch.randint(0, len(SPECIAL_BITS), (n,), generator=gen,
                          device=device)
    return torch.where(pick, special[which], v)


def make_ids(kind: str, n: int, g: int, gen: torch.Generator,
             device) -> torch.Tensor:
    """(n,) int32 segment ids of the given kind over [0, g)."""
    uniform = torch.randint(0, g, (n,), generator=gen, device=device,
                            dtype=torch.int32)
    if kind == "uniform":
        return uniform
    if kind == "hot":
        hot = torch.rand(n, generator=gen, device=device) < 0.9
        return torch.where(hot, g // 2, uniform).to(torch.int32)
    if kind == "sorted":
        return torch.sort(uniform)[0]
    if kind == "outside":
        # a quarter below 0 or at/after g, dropped by both versions
        out = torch.randint(0, 4, (n,), generator=gen, device=device)
        return torch.where(out == 0, -1 - uniform,
                           torch.where(out == 1, g + uniform, uniform)
                           ).to(torch.int32)
    raise ValueError(f"unknown id kind {kind!r}")


def misaligned(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous view equal to ``x`` that starts ``offset`` elements
    into a fresh buffer (not 16-byte aligned for offsets 1-3)."""
    buf = torch.zeros(x.shape[0] + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:]
    view.copy_(x)
    return view


def sum_bound(values: torch.Tensor, ids: torch.Tensor, g: int):
    """(exact float64 segment sums, float32 accumulation bound count *
    2^-23 * sum|v|) of the rows whose id lies in [0, g)."""
    keep = (ids >= 0) & (ids < g)
    idx = ids[keep].long()
    v = values[keep].double()
    dev = values.device

    def acc(w):
        return torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
            0, idx, w)

    return acc(v), acc(torch.ones_like(v)) * 2.0**-23 * acc(v.abs())


def held(got: torch.Tensor, want: torch.Tensor, values: torch.Tensor,
         ids: torch.Tensor, g: int, op: str) -> bool:
    """Whether the kernel's ``got`` holds to the plain version's
    ``want``: bit for bit, except float32 sums within their bound."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if op == "sum" and got.dtype == torch.float32:
        exact, bound = sum_bound(values, ids, g)
        return bool(((got.double() - exact).abs() <= bound).all())
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def packed(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Values (as int32 bits) and ids in one int32 tensor, so one static
    input carries both through ``scan_cases.graph_replays`` /
    ``two_streams``."""
    return torch.cat([values.view(torch.int32), ids])


def unpacking(kernel, n: int, dtype, g: int, op: str):
    """``kernel(values, ids, g, op)`` over a ``packed`` tensor of ``n``
    rows, its output as int32 bits (so NaNs compare equal)."""
    return lambda x: kernel(x[:n].view(dtype), x[n:], g, op).view(
        torch.int32)
