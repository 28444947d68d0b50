"""K3, the group-boundary scan, as a CUDA kernel
(``csrc/group_build.cu``).

Replaces
``src/repro/kernels/hash_dedup/group_build.py::group_boundaries_kernel``.
The TPU kernel carries the previous tile's last key and the running
boundary count across its sequential grid in SMEM. Here the group id is
the one-pass decoupled look-back scan of ``csrc/scan_lookback.cuh``,
whose prologue turns each tile's keys into boundary flags (each key's
predecessor from the registers of its own and the neighbouring lanes),
so every key is read once: one memset of the tile status words and one
launch per call. The port drops the reference's pow2 padding, so every
row is live and the TPU kernel's ``valid`` operand is gone.
Memory-bound: 12 bytes per element.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import group_boundaries_ref


def group_boundaries_kernel(sort_keys: torch.Tensor):
    """(N,) int32 sorted keys -> (bnd, gid) int32 pair: boundary flags
    (row 0 and every key unlike its predecessor) and per-sorted-position
    group ids. Launches the CUDA kernel for CUDA tensors; CPU tensors
    take the plain version."""
    if sort_keys.device.type != "cuda":
        return group_boundaries_ref(sort_keys)
    _build.check_cuda(sort_keys, "sort_keys", torch.int32, 1)
    n = sort_keys.shape[0]
    bnd = torch.empty_like(sort_keys)
    gid = torch.empty_like(sort_keys)
    if n == 0:
        return bnd, gid
    scratch = _build.lookback_scratch(n, sort_keys)
    _build.call("repro_group_boundaries", sort_keys.device,
                _build.ptr(sort_keys), _build.ptr(bnd), _build.ptr(gid),
                _build.ptr(scratch), n, _build.stream(sort_keys))
    _build.count_launch("group_boundaries", sort_keys.shape)
    return bnd, gid
