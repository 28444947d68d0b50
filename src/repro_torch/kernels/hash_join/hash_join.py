"""K6, one stable counting-rank pass of the hash join's LSD radix sort,
as a CUDA kernel (``csrc/radix_rank.cu``).

Replaces ``src/repro/kernels/hash_join/hash_join.py::radix_rank_kernel``,
which carries (256,) per-bucket running counts across its sequential
grid in VMEM and ranks inside a tile with a (rows x 256) one-hot
cumsum. On Hopper, one pass: each block takes the next tile from an
atomic counter, ranks it warp by warp from registers
(``__match_any_sync`` groups, per-warp counter rows of B buckets, no
block barrier in the walk), publishes its per-bucket counts as 64-bit
flag-and-value status words and finds each bucket's exclusive prefix
by a decoupled look-back over the earlier tiles' words. One memset and
one launch; bound: bytes, 8N plus B status words per tile.
"""
from __future__ import annotations

import torch

from .. import _build

NBUCKETS = 256  # one 8-bit digit per pass
MAX_BUCKETS = 1024  # eight warps' counter rows of B ints in shared memory


def radix_rank_torch(digits: torch.Tensor, base: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of the K6 kernel: row i's destination
    ``base[digits[i]] + #{j < i : digits[j] == digits[i]}``, from a
    stable argsort by digit."""
    n = digits.shape[0]
    order = torch.argsort(digits, stable=True)
    sd = digits[order].long()
    hist = torch.zeros(base.shape[0], dtype=torch.int64,
                       device=digits.device)
    hist.index_add_(0, sd, torch.ones_like(sd))
    first = torch.cumsum(hist, 0) - hist
    rank = torch.arange(n, device=digits.device) - first[sd]
    dest = torch.empty_like(digits)
    dest[order] = (base.long()[sd] + rank).to(torch.int32)
    return dest


def radix_rank_kernel(digits: torch.Tensor, base: torch.Tensor
                      ) -> torch.Tensor:
    """digits: (N,) int32 in [0, B); base: (B,) int32 exclusive bucket
    offsets -> (N,) int32 stable scatter destinations: row i lands at
    ``base[digits[i]] + #{j < i : digits[j] == digits[i]}``. B is
    ``NBUCKETS`` for the hash join; any B up to ``MAX_BUCKETS`` works.
    Launches the CUDA kernel (one memset, one launch) for CUDA tensors;
    CPU tensors take the plain version."""
    if digits.device.type != "cuda":
        return radix_rank_torch(digits, base)
    _build.check_cuda(digits, "digits", torch.int32, 1)
    _build.check_cuda(base, "base", torch.int32, 1)
    buckets = base.shape[0]
    if not 1 <= buckets <= MAX_BUCKETS:
        raise ValueError(f"base: 1..{MAX_BUCKETS} buckets, got {buckets}")
    n = digits.shape[0]
    dest = torch.empty_like(digits)
    if n == 0:
        return dest
    tiles = _build.library().repro_radix_rank_tiles(n)
    scratch = torch.empty(1 + tiles * buckets, dtype=torch.int64,
                          device=digits.device)
    _build.call("repro_radix_rank", digits.device, _build.ptr(digits),
                _build.ptr(base), _build.ptr(dest), _build.ptr(scratch), n,
                buckets, _build.stream(digits))
    _build.count_launch("radix_rank", digits.shape)
    return dest
