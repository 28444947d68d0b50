"""Oracles for the data-tier partition ops: shard routing (Fibonacci
top bits over the FNV-1a row hash) and the stable bucket rank, as plain
PyTorch versions plus their exact numpy mirrors.

The routing contract both pin down bit for bit: a row with key hash
``h`` (uint32, the ``hash_rows`` family) lives on shard
``(h * FIB_MULT) >> (32 - log2 P)``. The multiplicative spread uses the
TOP bits, so it composes with structures that consume the LOW bits of
the same hash (the ``VerdictTable`` keeps its in-shard slot from
``h & (local_capacity - 1)``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..hash_join.hash_join import radix_rank_torch
from ..hash_join.ref import FIB_MULT, fib_hash_torch

__all__ = ["FIB_MULT", "shard_bits", "shard_of_torch", "shard_of_np",
           "shard_rank_torch", "shard_rank_np"]


def shard_bits(n_shards: int) -> int:
    """log2 of a power-of-two shard count (validated)."""
    if n_shards < 1 or n_shards & (n_shards - 1):
        raise ValueError(f"n_shards must be a power of two: {n_shards}")
    return n_shards.bit_length() - 1


def shard_of_torch(h: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(N,) key hashes (uint32, or int32 holding the uint32 bits) ->
    (N,) int32 owning shard. The uint32 product is computed in int64
    from 16-bit halves (``fib_hash_torch``): ``>>`` on uint32 tensors
    is not implemented on every device."""
    bits = shard_bits(n_shards)
    if h.dtype == torch.uint32:
        h = h.view(torch.int32)
    if bits == 0:
        return torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    return fib_hash_torch(h, bits)


def shard_of_np(h, n_shards: int) -> np.ndarray:
    """Exact numpy mirror of ``shard_of_torch`` (uint32 wrap-around is
    numpy's native modular arithmetic)."""
    bits = shard_bits(n_shards)
    h = np.asarray(h, dtype=np.uint32)
    if bits == 0:
        return np.zeros(h.shape, dtype=np.int32)
    spread = h * FIB_MULT
    return (spread >> np.uint32(32 - bits)).astype(np.int32)


def shard_rank_torch(dest: torch.Tensor, base: torch.Tensor,
                     n_shards: int) -> torch.Tensor:
    """Plain version of the K10 kernel: (N,) int32 destinations in
    [0, n_shards) + (n_shards,) int32 exclusive bucket offsets -> (N,)
    int32 scatter positions ``base[dest] + #{earlier rows with the same
    dest}``, from a stable argsort by destination (the counting rank
    K6's plain version computes over any bucket count)."""
    if base.shape[0] != n_shards:
        raise ValueError(f"base: expected {n_shards} offsets, got "
                         f"{base.shape[0]}")
    return radix_rank_torch(dest, base)


def shard_rank_np(dest, base, n_shards: int) -> np.ndarray:
    """Exact numpy oracle for the rank kernel (stable argsort)."""
    dest = np.asarray(dest, dtype=np.int32)
    base = np.asarray(base, dtype=np.int32)
    out = np.empty(dest.shape[0], dtype=np.int32)
    order = np.argsort(dest, kind="stable")
    sorted_d = dest[order]
    starts = np.searchsorted(sorted_d, np.arange(n_shards, dtype=np.int32),
                             side="left")
    within = np.arange(dest.shape[0]) - starts[sorted_d]
    out[order] = base[sorted_d] + within.astype(np.int32)
    return out
