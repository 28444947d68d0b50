"""Host-facing wrappers: the hash and sort-merge physical equi-joins.

``hash_join_match`` is the open-addressing hash join on int32-codable
keys: build the table from the build side on the device (torch
scatter-min claim rounds with linear probing), probe in one pass, and
expand matches with the device expansion (prefix-count and segment-id
kernels). The grouped build order — build rows stable-sorted by slot —
is ⌈hbits/8⌉ passes of the K6 radix rank on ``impl="kernel"`` (and
``"auto"`` on a CUDA device), a stable ``torch.argsort`` on ``"ref"``.
``impl="host"`` (and ``"auto"`` on the CPU) is the exact
``hash_join_np`` oracle, recorded as a ``host_fallbacks["hash_join"]``
serving.

``sorted_probe_match`` is the join the planner picks when the build
side is already sorted by the key (an aggregate output): no build at
all, a fused searchsorted over the sorted keys and the same device
match expansion.

Both device joins cost ONE device→host sync — the scalar match total
(site ``"hash_join_probe"``); the hash build and probe loops also fetch
their exit test (``ref.LOOP_FETCHES``, outside ``HOST_SYNCS`` as in the
reference). Match lists come back as device int32 tensors,
probe-major with build rows ascending per probe row, bit-identical to
the numpy oracles.
"""
from __future__ import annotations

import numpy as np
import torch

from ..segmented_reduce.ops import _probe_expand_device
from ..segmented_reduce.segmented_reduce import segment_reduce_kernel
from ..sync import HOST_SYNCS
from ..util import (
    as_device,
    check_int32_domain,
    is_device_array,
    resolve_impl,
    to_numpy,
)
from .hash_join import NBUCKETS, radix_rank_kernel
from .ref import (
    hash_join_np,
    hash_table_build_torch,
    hash_table_probe_torch,
    sorted_probe_match_np,
    table_bits,
)

_EMPTY = np.zeros(0, dtype=np.int64)


def _radix_order(slot_key: torch.Tensor, *, key_bits: int) -> torch.Tensor:
    """Stable LSD radix sort of row ids by ``slot_key`` (values in
    [0, 2**key_bits)): per 8-bit pass a histogram (the K5 segmented sum
    of ones over the digits — a torch ``index_add_`` into 256 bins
    serialises its atomics), the K6 rank and a scatter. Returns the
    grouped build order (slot-major, row-ascending within a slot).

    The reference sorts ``hbits + 1`` bits, because its pow2 pad rows
    carry the key ``2**hbits``; the port has no pad rows, so
    ``slot_key < 2**hbits`` and ``key_bits = hbits`` — ⌈hbits/8⌉
    passes. The order is the same either way."""
    n = slot_key.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=slot_key.device)
    ones = torch.ones_like(rows)
    key = slot_key
    for shift in range(0, key_bits, 8):
        digit = (key >> shift) & (NBUCKETS - 1)
        hist = segment_reduce_kernel(ones, digit, NBUCKETS, "sum")
        base = (torch.cumsum(hist, 0) - hist).to(torch.int32)
        dest = radix_rank_kernel(digit, base).long()
        rows = torch.empty_like(rows).index_copy_(0, dest, rows)
        if shift + 8 < key_bits:
            key = torch.empty_like(key).index_copy_(0, dest, key)
    return rows


def _stable_order(slot_key: torch.Tensor, key_bits: int, impl: str
                  ) -> torch.Tensor:
    """Rows stable-sorted by ``slot_key``: K6 radix passes on the
    kernel impl, a stable argsort on ``ref``."""
    if impl == "ref":
        return torch.argsort(slot_key, stable=True).to(torch.int32)
    return _radix_order(slot_key, key_bits=key_bits)


def _slot_lookup(pk: torch.Tensor, key_col: torch.Tensor,
                 owner: torch.Tensor, counts_slot: torch.Tensor,
                 starts_slot: torch.Tensor, hbits: int):
    """Probe the table, then look up each probe row's match run:
    (cnt, offs) int32 per probe row into the grouped build order, plus
    the exact int64 match total (a 0-d tensor)."""
    pslot = hash_table_probe_torch(pk, key_col, owner, hbits)
    hit = pslot >= 0
    pslot_c = torch.where(hit, pslot, 0)
    cnt = torch.where(hit, torch.index_select(counts_slot, 0, pslot_c), 0)
    offs = torch.where(hit, torch.index_select(starts_slot, 0, pslot_c), 0)
    return cnt, offs, cnt.sum(dtype=torch.int64)


def _hash_join_device(pk: torch.Tensor, bk: torch.Tensor, *, hbits: int,
                      impl: str):
    """Build + probe + per-slot segment structures on the device.
    Returns per-probe (cnt, offs) into the grouped build ``order``, the
    order itself and the int64 match total (a 0-d tensor)."""
    h = 1 << hbits
    owner, slot_of = hash_table_build_torch(bk, hbits)
    # slot-indexed counts/starts over H: no dense group ids
    counts_slot = torch.zeros(h, dtype=torch.int32, device=bk.device)
    counts_slot.index_add_(0, slot_of, torch.ones_like(slot_of))
    starts_slot = (torch.cumsum(counts_slot, 0) - counts_slot).to(
        torch.int32)
    order = _stable_order(slot_of, hbits, impl)
    cnt, offs, total = _slot_lookup(pk, bk, owner, counts_slot,
                                    starts_slot, hbits)
    return cnt, offs, order, total


def _host_oracle(probe_keys, build_keys, sorted_build: bool):
    """Serve the join from the exact numpy oracle, accounting the key
    fetches (device columns) and the ``hash_join`` fallback."""
    for a in (probe_keys, build_keys):
        if is_device_array(a):
            HOST_SYNCS.tick(site="hash_join_keys")
    HOST_SYNCS.fallback("hash_join")
    pk = np.ascontiguousarray(to_numpy(probe_keys), dtype=np.int32)
    bk = np.ascontiguousarray(to_numpy(build_keys), dtype=np.int32)
    if sorted_build:
        return sorted_probe_match_np(pk, bk)
    return hash_join_np(pk, bk)


def _keys_device(probe_keys, build_keys, device) -> torch.device:
    for a in (probe_keys, build_keys):
        if isinstance(a, torch.Tensor):
            return a.device
    return as_device(device)


def _device_keys(keys, dev: torch.device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=dev, dtype=torch.int32).contiguous()
    return torch.as_tensor(np.asarray(keys, dtype=np.int32), device=dev)


def _empty(impl: str, dev: torch.device):
    if impl != "host":
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return empty, empty
    return _EMPTY.copy(), _EMPTY.copy()


def _join(probe_keys, build_keys, impl: str, device, sorted_build: bool):
    """The two device joins' shared frame: empty sides, the host
    oracle, ONE fetch of the match total (site ``"hash_join_probe"``),
    the int32 domain guard and the device expansion."""
    dev = _keys_device(probe_keys, build_keys, device)
    impl = resolve_impl(impl, "host", dev)
    if int(np.shape(probe_keys)[0]) == 0 or \
            int(np.shape(build_keys)[0]) == 0:
        return _empty(impl, dev)
    if impl == "host":
        return _host_oracle(probe_keys, build_keys, sorted_build)
    pk = _device_keys(probe_keys, dev)
    bk = _device_keys(build_keys, dev)
    if sorted_build:
        cnt, offs, order, total = _sorted_lookup_device(pk, bk)
    else:
        cnt, offs, order, total = _hash_join_device(
            pk, bk, hbits=table_bits(bk.shape[0]), impl=impl)
    total = int(total)
    HOST_SYNCS.tick(site="hash_join_probe")
    check_int32_domain(total, dev, "hash join family")
    if total > 2**30:
        # pathological skew join on the CPU: int32 indices cannot
        # address the expansion — keep the exact int64 host oracle
        return _host_oracle(probe_keys, build_keys, sorted_build)
    if total == 0:
        return _empty(impl, dev)
    return _probe_expand_device(cnt, offs, order, total, impl)


def hash_join_match(probe_keys, build_keys, *, impl: str = "auto",
                    device=None):
    """Equi-join match lists via the open-addressing hash table:
    ``(out_probe, out_build)`` index pairs, probe-major with build rows
    ascending per probe row — bit-identical to ``join_match_lists`` and
    to the ``hash_join_np`` oracle. Keys must be int32-codable; device
    impls return int32 tensors on the keys' device (``device`` when
    both are host arrays), the host oracle int64 numpy."""
    return _join(probe_keys, build_keys, impl, device, sorted_build=False)


def _sorted_lookup_device(pk: torch.Tensor, bk: torch.Tensor):
    """Fused sort-merge probe over an ascending build column: the run
    ``[lo, hi)`` positions ARE build row indices, so the grouped order
    is the identity."""
    lo = torch.searchsorted(bk, pk)
    hi = torch.searchsorted(bk, pk, right=True)
    cnt = (hi - lo).to(torch.int32)
    offs = torch.where(cnt > 0, lo, 0).to(torch.int32)
    order = torch.arange(bk.shape[0], dtype=torch.int32, device=bk.device)
    return cnt, offs, order, cnt.sum(dtype=torch.int64)


def sorted_probe_match(probe_keys, build_keys, *, impl: str = "auto",
                       device=None):
    """Sort-merge equi-join over a build side ALREADY sorted ascending
    by the key (the caller's contract — ``Table.sorted_by`` guards it).
    ``(out_probe, out_build)`` index pairs, probe-major with build rows
    ascending per probe row: int32 tensors on device impls, int64 numpy
    on the host oracle."""
    return _join(probe_keys, build_keys, impl, device, sorted_build=True)
