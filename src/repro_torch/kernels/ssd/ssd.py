"""K9, the Mamba-2 SSD intra-chunk step in float32, as a CUDA kernel
(``csrc/ssd.cu``).

Replaces ``src/repro/kernels/ssd/ssd.py::ssd_chunk_kernel``, whose grid
takes one (row, chunk) cell per sequential step with every head inside,
sized for the 128x128 MXU. On Hopper that is too few cells to fill 132
SMs, so the work is split in two launches: C·Bᵀ once per (row, chunk)
in 32x32 tiles (shared by every head, kept in a global scratch), then
one block per (row, chunk, head) for the prefix sum of dt·A, y_diag
and the chunk state. Bound: operations at the model's widths (see the
source note). The plain version is ``ref.py::ssd_chunk_ref``.
"""
from __future__ import annotations

import torch

from .. import _build

MAX_CHUNK = 128
MAX_HEAD_DIM = 128


def ssd_chunk_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x: (b, s, h, p), dt: (b, s, h) post-softplus, A: (h,), B/C:
    (b, s, n), float32 CUDA tensors, s % chunk == 0, chunk <= 128,
    p <= 128. x, B and C are read through their strides (unit stride on
    the last axis: the model passes slices of its conv output); dt and A
    must be contiguous. Returns (y_diag (b,s,h,p), states (b,nc,h,p,n),
    chunk_decay (b,nc,h), cum (b,s,h)). Raises for a tensor off the
    card: there is no fallback."""
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
    cb = torch.empty((b, nc, chunk, chunk), dtype=torch.float32,
                     device=dev)  # C·Bᵀ scratch, lower triangle only
    _build.call("repro_ssd_chunk", dev, _build.ptr(x), _build.ptr(dt),
                _build.ptr(A), _build.ptr(B), _build.ptr(C), _build.ptr(y),
                _build.ptr(st), _build.ptr(dec), _build.ptr(cum),
                _build.ptr(cb), b, s, h, p, n, chunk, *x.stride()[:3],
                *B.stride()[:2], *C.stride()[:2], _build.stream(x))
    _build.count_launch("ssd_chunk", (b, s, h, p, n, chunk))
    return y, st, dec, cum
