"""Host-facing wrappers for the partition family.

``shard_destinations`` maps key rows to their owning shard (FNV-1a row
hash -> Fibonacci top bits, the routing contract ``ref.py`` pins down)
and ``shard_rank`` assigns every row its stable position inside the
fixed-stride exchange bucket. Both take the three-impl ``impl=``
token: ``"kernel"`` runs the CUDA kernels (K2 for the hash, K10 for
the rank; their plain versions for CPU tensors), ``"ref"`` the plain
PyTorch versions, ``"host"`` the exact numpy oracle (recorded as a host
fallback). The mesh orchestration that consumes them — the shard-local
loop, the single exchange, collective accounting — lives in
``sharding/data.py``.
"""
from __future__ import annotations

import torch

from ..hash_dedup.ops import hash_rows
from ..hash_dedup.ref import hash_rows_np
from ..sync import HOST_SYNCS
from ..util import is_device_array, np_dtype, resolve_impl, to_numpy
from .partition import shard_rank_kernel
from .ref import shard_of_np, shard_of_torch, shard_rank_np, shard_rank_torch


def shard_destinations(keys, n_shards: int, *, impl: str = "auto"):
    """(N, C) int32 key rows -> (N,) int32 owning shard.

    Device impls hash where the keys lie (K2 under ``"kernel"``) and
    keep the result there; ``impl="host"`` is the exact numpy oracle
    over host keys (a host fallback)."""
    impl = resolve_impl(impl, "ref", keys)
    if impl == "host":
        HOST_SYNCS.fallback("shard_rank")
        return shard_of_np(hash_rows_np(to_numpy(keys)), n_shards)
    k = torch.as_tensor(keys).to(torch.int32).contiguous()
    return shard_of_torch(hash_rows(k, impl=impl), n_shards)


def shard_rank(dest, base, *, n_shards: int, impl: str = "auto"):
    """Stable scatter positions into fixed-stride shard buckets:
    ``base[dest] + #{earlier rows with the same dest}``. Rows keep
    their relative order inside each bucket — the property the
    exchange leans on to reproduce single-device float accumulation
    order after the exchange."""
    impl = resolve_impl(impl, "ref", dest)
    if impl == "host":
        HOST_SYNCS.fallback("shard_rank")
        return shard_rank_np(to_numpy(dest), to_numpy(base), n_shards)
    d = torch.as_tensor(dest).to(torch.int32).contiguous()
    b = torch.as_tensor(base).to(device=d.device,
                                 dtype=torch.int32).contiguous()
    if b.shape[0] != n_shards:
        raise ValueError(f"base: expected {n_shards} offsets, got "
                         f"{b.shape[0]}")
    if impl == "ref":
        return shard_rank_torch(d, b, n_shards)
    return shard_rank_kernel(d, b)


def is_partitionable(col) -> bool:
    """True for columns the partitioned operators accept as keys:
    device-resident narrow integers / booleans (the dtypes whose int32
    cast is exact AND whose sort order survives it). Floats (NaN group
    semantics), strings and 64-bit columns take the single-device
    path."""
    if not is_device_array(col):
        return False
    dt = np_dtype(col)
    return dt.kind in "ib" and dt.itemsize <= 4
