"""K10, the stable shard rank behind the data tier's exchange, as a CUDA
kernel (``csrc/shard_rank.cu``).

Replaces ``src/repro/kernels/partition/partition.py::shard_rank_kernel``,
which carries the (P,) per-bucket running counts across its sequential
grid in VMEM and ranks inside a tile through a (rows x P) one-hot
cumsum. On Hopper, for P <= 32 shard buckets: each warp holds a
contiguous run of 512 rows in registers and one row of 32 counters in
shared memory (every bucket); per-tile bucket counts from
``__match_any_sync`` groups, a per-bucket scan of the (P, tiles) count
matrix in tile order, then the in-tile rank walked warp by warp with no
block-wide barrier. It is not K6 (``radix_rank.cu``), whose shared
histograms, per-warp rank state and block-synchronised 256-row steps
are sized for 256 buckets. Memory-bound: 8N bytes, 12N moved.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import shard_rank_torch

MAX_SHARDS = 32  # one warp's lanes hold every bucket


def shard_rank_kernel(dest: torch.Tensor, base: torch.Tensor
                      ) -> torch.Tensor:
    """dest: (N,) int32 in [0, P); base: (P,) int32 exclusive bucket
    offsets, P <= ``MAX_SHARDS`` -> (N,) int32 stable scatter
    destinations: row i lands at
    ``base[dest[i]] + #{j < i : dest[j] == dest[i]}``. Launches the CUDA
    kernel for CUDA tensors; CPU tensors take the plain version."""
    n_shards = base.shape[0]
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"base: 1..{MAX_SHARDS} shard buckets, got "
                         f"{n_shards}")
    if dest.device.type != "cuda":
        return shard_rank_torch(dest, base, n_shards)
    _build.check_cuda(dest, "dest", torch.int32, 1)
    _build.check_cuda(base, "base", torch.int32, 1)
    n = dest.shape[0]
    out = torch.empty_like(dest)
    if n == 0:
        return out
    tiles = _build.library().repro_shard_rank_tiles(n)
    counts = torch.empty(tiles * n_shards, dtype=torch.int32,
                         device=dest.device)
    _build.call("repro_shard_rank", dest.device, _build.ptr(dest),
                _build.ptr(base), _build.ptr(out), _build.ptr(counts), n,
                n_shards, _build.stream(dest))
    _build.count_launch("shard_rank", dest.shape)
    return out
