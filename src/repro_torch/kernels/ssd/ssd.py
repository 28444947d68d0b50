"""K9, the Mamba-2 SSD intra-chunk step in float32, as a CUDA kernel
(``csrc/ssd.cu``).

Replaces ``src/repro/kernels/ssd/ssd.py::ssd_chunk_kernel``, whose grid
takes one (row, chunk) cell per sequential step with every head inside,
sized for the 128x128 MXU. On Hopper that is too few cells to fill 132
SMs, so one launch takes one block per (row, chunk, group of heads)
(``head_groups``): C·Bᵀ once per block into shared memory while one
warp takes the in-chunk prefix sums of dt·A (sequential, no FMA: cum
and the decays bit for bit as the plain version sums them), then per
head y_diag on four warps and the chunk state on the other four, x
staged by ``cp.async``. Every product runs on the tensor cores in
error-compensated TF32: each float32 operand is split into two TF32
parts and a product is three ``mma.sync`` products
(``csrc/mma_tf32x3.cuh``), within a few float32 ulps where one TF32
product would be off by ~5e-4 relative. Bound: bytes at the model's
widths (see the source note). The plain version is
``ref.py::ssd_chunk_ref``.
"""
from __future__ import annotations

import torch

from .. import _build
from ..util import refuse_autograd

MAX_CHUNK = 128
MAX_HEAD_DIM = 128


_GROUPS: dict[tuple, int] = {}


def head_groups(b: int, nc: int, h: int, chunk: int, p: int, n: int,
                device: torch.device) -> int:
    """Groups the h heads are split into, one block per (row, chunk,
    group): the most that still run in one wave on the card (each block
    computes C·Bᵀ once for its heads, so fewer groups repeat it less; a
    second wave would leave SMs idle behind it), within shared memory
    (``repro_ssd_groups`` in ``csrc/ssd.cu``). Worked out once per shape
    and card."""
    key = (b, nc, h, chunk, p, n, device.index)
    if key not in _GROUPS:
        with torch.cuda.device(device):
            groups = _build.library().repro_ssd_groups(b, nc, h, chunk, p,
                                                       n)
        if groups < 1:
            raise ValueError(f"K9 cannot hold one head at chunk {chunk}, "
                             f"head_dim {p}, state {n} in shared memory")
        _GROUPS[key] = groups
    return _GROUPS[key]


def ssd_chunk_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x: (b, s, h, p), dt: (b, s, h) post-softplus, A: (h,), B/C:
    (b, s, n), float32 CUDA tensors, s % chunk == 0, chunk <= 128,
    p <= 128. x, B and C are read through their strides (unit stride on
    the last axis: the model passes slices of its conv output); dt and A
    must be contiguous. Returns (y_diag (b,s,h,p), states (b,nc,h,p,n),
    chunk_decay (b,nc,h), cum (b,s,h)), in one block per row, chunk and
    head group (``head_groups``). Raises for a tensor off the card:
    there is no fallback."""
    refuse_autograd("ssd_chunk_kernel", x, dt, A, B, C)
    _build.check_cuda(x, "x", torch.float32, 4, contiguous=False)
    _build.check_cuda(dt, "dt", torch.float32, 3)
    _build.check_cuda(A, "A", torch.float32, 1)
    for t, name in ((B, "B"), (C, "C")):
        _build.check_cuda(t, name, torch.float32, 3, contiguous=False)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} and A {tuple(A.shape)} must "
                         f"be ({b}, {s}, {h}) and ({h},) for x "
                         f"{tuple(x.shape)}")
    if B.shape != (b, s, n) or C.shape != (b, s, n):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"be (b, s, n) for x {tuple(x.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide s = {s}")
    if not 1 <= p <= MAX_HEAD_DIM or n < 1:
        raise ValueError(f"head_dim {p} outside [1, {MAX_HEAD_DIM}] or no "
                         f"state (n = {n})")
    nc = s // chunk
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    st = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
    dec = torch.empty((b, nc, h), dtype=torch.float32, device=dev)
    cum = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    if b * s * h == 0:
        return y, st, dec, cum
    groups = head_groups(b, nc, h, chunk, p, n, dev)
    _build.call("repro_ssd_chunk", dev, _build.ptr(x), _build.ptr(dt),
                _build.ptr(A), _build.ptr(B), _build.ptr(C), _build.ptr(y),
                _build.ptr(st), _build.ptr(dec), _build.ptr(cum), b, s, h,
                p, n, chunk, groups, *x.stride()[:3], *B.stride()[:2],
                *C.stride()[:2], _build.stream(x))
    _build.count_launch("ssd_chunk", (b, s, h, p, n, chunk))
    return y, st, dec, cum
