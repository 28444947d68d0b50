"""K2, the FNV-1a row hash, as a CUDA kernel (``csrc/hash_rows.cu``).

Replaces ``src/repro/kernels/hash_dedup/hash_dedup.py::hash_rows_kernel``:
one thread per row mixes the four little-endian bytes of each of the
row's C int32 words in uint32. Memory-bound: 4 * (C + 1) bytes per row.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import hash_rows_ref


def hash_rows_kernel(keys: torch.Tensor) -> torch.Tensor:
    """(N, C) int32 -> (N,) int32 holding each row's uint32 FNV-1a bits.
    Launches the CUDA kernel for a CUDA tensor; a CPU tensor takes the
    plain version."""
    if keys.device.type != "cuda":
        return hash_rows_ref(keys)
    _build.check_cuda(keys, "keys", torch.int32, 2)
    n, c = keys.shape
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    _build.call("repro_hash_rows", keys.device, _build.ptr(keys),
                _build.ptr(out), n, c, _build.stream(keys))
    _build.count_launch("hash_rows", keys.shape)
    return out
