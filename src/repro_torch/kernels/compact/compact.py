"""K1, the stream-compaction prefix count, as a CUDA kernel
(``csrc/compact.cu``).

Replaces ``src/repro/kernels/compact/compact.py::prefix_count_kernel``.
The TPU kernel carries the running count across its sequential grid in
SMEM; on Hopper the carry is a device-wide three-phase scan
(``csrc/scan.cuh``). Memory-bound: 8 bytes per element.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import prefix_count_torch


def prefix_count_kernel(flags: torch.Tensor) -> torch.Tensor:
    """(N,) int32 flags -> (N,) int32 inclusive running sum; the last
    element is the total. Launches the CUDA kernel for a CUDA tensor;
    a CPU tensor takes the plain version."""
    if flags.device.type != "cuda":
        return prefix_count_torch(flags)
    _build.check_cuda(flags, "flags", torch.int32, 1)
    n = flags.shape[0]
    out = torch.empty_like(flags)
    if n == 0:
        return out
    scratch = _build.scan_scratch(n, flags)
    _build.call("repro_prefix_count", flags.device, _build.ptr(flags),
                _build.ptr(out), _build.ptr(scratch), n,
                _build.stream(flags))
    _build.count_launch("prefix_count", flags.shape)
    return out
