"""Plain PyTorch versions (FNV-1a row hashes, first-occurrence dedup
mask, group-boundary scan) plus the exact numpy oracles for
``group_build``.

torch's uint32 is a thin dtype (no ``>>`` on the CPU, no sort on every
device), so the plain versions carry 32-bit hash values as int32 bit
patterns and compute the FNV arithmetic in int64, masked to 32 bits
after every multiply. ``ops.hash_rows`` returns uint32 at the public
boundary, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

FNV_OFFSET = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)
_MASK32 = 0xFFFFFFFF


def as_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def hash_rows_ref(keys: torch.Tensor) -> torch.Tensor:
    """Plain version of the CUDA FNV-1a kernel: (N, C) int32 -> (N,)
    int32 holding each row's uint32 hash bits."""
    h = torch.full((keys.shape[0],), int(FNV_OFFSET), dtype=torch.int64,
                   device=keys.device)
    for c in range(keys.shape[1]):
        w = keys[:, c].to(torch.int64) & _MASK32
        for shift in (0, 8, 16, 24):
            byte = (w >> shift) & 0xFF
            h = ((h ^ byte) * int(FNV_PRIME)) & _MASK32
    return as_int32_bits(h)


def first_occurrence_ref(hashes: torch.Tensor) -> torch.Tensor:
    """(N,) -> bool mask marking the first occurrence of each value."""
    n = hashes.shape[0]
    order = torch.argsort(hashes, stable=True)
    sorted_h = hashes[order]
    is_first = torch.ones(n, dtype=torch.bool, device=hashes.device)
    is_first[1:] = sorted_h[1:] != sorted_h[:-1]
    mask = torch.zeros(n, dtype=torch.bool, device=hashes.device)
    mask[order] = is_first
    return mask


def group_boundaries_ref(sort_keys: torch.Tensor):
    """Plain version of the CUDA boundary scan: (N,) sorted int32 keys
    -> (bnd, gid) int32 pair (boundary flags — row 0 and every key
    unlike its predecessor — and per-sorted-position group ids =
    cumsum(bnd) - 1)."""
    prev = torch.cat([sort_keys[:1] ^ 1, sort_keys[:-1]])
    bnd = (sort_keys != prev).to(torch.int32)
    gid = (torch.cumsum(bnd, 0) - 1).to(torch.int32)
    return bnd, gid


def hash_rows_np(keys, basis: np.uint32 = FNV_OFFSET) -> np.ndarray:
    """Exact numpy FNV-1a: (N, C) int32 -> (N,) uint32 row hashes
    (numpy's modular uint32 arithmetic). A non-default ``basis`` yields
    an independent hash family — the verdict table's fingerprint."""
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    h = np.full(keys.shape[0], np.uint32(basis), dtype=np.uint32)
    for c in range(keys.shape[1]):
        w = keys[:, c].astype(np.uint32)
        for shift in (0, 8, 16, 24):
            byte = (w >> np.uint32(shift)) & np.uint32(0xFF)
            h = (h ^ byte) * FNV_PRIME
    return h


def column_codes_np(key_columns) -> np.ndarray:
    """Exact numpy oracle for the device code-assignment pass: encode
    arbitrary-dtype group-key columns as an (N, C) int32 code matrix.

    Codes are order-isomorphic to the column values (np.unique's sorted
    code space). Every NaN key value gets its own code, ascending in row
    order after every non-NaN value (``np.unique(axis=0)`` never
    equates NaN rows).
    """
    out = []
    for kv in key_columns:
        kv = np.asarray(kv)
        if kv.dtype.kind in "fc" and np.isnan(kv).any():
            isn = np.isnan(kv)
            uniq, inv = np.unique(kv[~isn], return_inverse=True)
            codes = np.empty(len(kv), dtype=np.int64)
            codes[~isn] = inv
            codes[isn] = len(uniq) + np.arange(int(isn.sum()))
            out.append(codes)
        else:
            out.append(np.unique(kv, return_inverse=True)[1].astype(np.int64))
    return np.stack(out, axis=1).astype(np.int32)


def group_build_np(keys):
    """Exact numpy oracle for ``ops.group_build`` (hash grouping, no
    collision repair): groups ordered by ascending 32-bit sort key (the
    raw key column for C == 1, the FNV-1a row hash otherwise). Returns
    ``(num_groups, group_ids, reps, counts, starts, order, sort_keys)``.
    """
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    sk = keys[:, 0] if keys.shape[1] == 1 else hash_rows_np(keys)
    uniq, reps, inverse, counts = np.unique(
        sk, return_index=True, return_inverse=True, return_counts=True)
    order = np.argsort(inverse, kind="stable")
    starts = np.zeros(len(uniq), dtype=np.int64)
    if len(uniq):
        np.cumsum(counts[:-1], out=starts[1:])
    return (len(uniq), inverse.astype(np.int64), reps.astype(np.int64),
            counts.astype(np.int64), starts, order.astype(np.int64), sk)
