"""K10, the stable shard rank behind the data tier's exchange, as a CUDA
kernel (``csrc/shard_rank.cu``).

Replaces ``src/repro/kernels/partition/partition.py::shard_rank_kernel``,
which carries the (P,) per-bucket running counts across its sequential
grid in VMEM and ranks inside a tile through a (rows x P) one-hot
cumsum. On Hopper, for P <= 32 shard buckets: one memset and one launch,
a decoupled look-back over per-bucket status words. Each warp holds a
contiguous run of 1024 rows in registers and ranks it 32 rows a step
(one ballot per bucket up to 4 buckets, per bucket bit above); each
8192-row tile publishes its bucket counts, its 8 warps look back over
the predecessors' words (a window of 8 x 32 words covers 256 / P
predecessors of every bucket, P rounded up to a power of two), and each
row then lands at its bucket's offset plus its rank, from registers.
Bound and traffic: 8N bytes, the destinations read once.
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
    # the tile counter and one status word per (tile, bucket), zeroed by
    # the call's own memset
    scratch = torch.empty(1 + tiles * n_shards, dtype=torch.int64,
                          device=dest.device)
    _build.call("repro_shard_rank", dest.device, _build.ptr(dest),
                _build.ptr(base), _build.ptr(out), _build.ptr(scratch), n,
                n_shards, _build.stream(dest))
    _build.count_launch("shard_rank", dest.shape)
    return out
