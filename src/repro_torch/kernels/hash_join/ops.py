"""Host-facing wrappers: the sort-merge physical equi-join.

``sorted_probe_match`` is the join the planner picks when the build
side is already sorted by the key (an aggregate output): no build at
all, a fused searchsorted over the sorted keys and the device match
expansion (prefix-count and segment-id kernels), one scalar fetch per
join (site ``"hash_join_probe"``). ``impl="host"`` (and ``"auto"`` on
the CPU) is the exact numpy oracle, recorded as a
``host_fallbacks["hash_join"]`` serving.

``hash_join_match`` — the open-addressing hash join with the radix-rank
kernel (K6) — is port slice 2 and raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..segmented_reduce.ops import _probe_expand_device
from ..sync import HOST_SYNCS
from ..util import (
    as_device,
    check_int32_domain,
    is_device_array,
    resolve_impl,
    to_numpy,
)
from .ref import sorted_probe_match_np

_EMPTY = np.zeros(0, dtype=np.int64)

HASH_JOIN_TODO = "hash join: port slice 2"


def hash_join_match(probe_keys, build_keys, *, impl: str = "auto"):
    """Open-addressing hash join (radix-rank kernel K6): not ported."""
    raise NotImplementedError(HASH_JOIN_TODO)


def _host_oracle(probe_keys, build_keys):
    """Serve the sort-merge join from the numpy oracle, accounting the
    key fetches (device columns) and the ``hash_join`` fallback."""
    for a in (probe_keys, build_keys):
        if is_device_array(a):
            HOST_SYNCS.tick(site="hash_join_keys")
    HOST_SYNCS.fallback("hash_join")
    pk = np.ascontiguousarray(to_numpy(probe_keys), dtype=np.int32)
    bk = np.ascontiguousarray(to_numpy(build_keys), dtype=np.int32)
    return sorted_probe_match_np(pk, bk)


def _device_keys(keys, dev: torch.device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=dev, dtype=torch.int32).contiguous()
    return torch.as_tensor(np.asarray(keys, dtype=np.int32), device=dev)


def sorted_probe_match(probe_keys, build_keys, *, impl: str = "auto",
                       device=None):
    """Sort-merge equi-join over a build side ALREADY sorted ascending
    by the key (the caller's contract — ``Table.sorted_by`` guards it).
    ``(out_probe, out_build)`` index pairs, probe-major with build rows
    ascending per probe row: int32 tensors on device impls, int64 numpy
    on the host oracle."""
    dev = as_device(device)
    for a in (probe_keys, build_keys):
        if isinstance(a, torch.Tensor):
            dev = a.device
            break
    impl = resolve_impl(impl, "host", dev)
    n_probe = int(np.shape(probe_keys)[0])
    n_build = int(np.shape(build_keys)[0])
    if n_probe == 0 or n_build == 0:
        if impl != "host":
            empty = torch.zeros(0, dtype=torch.int32, device=dev)
            return empty, empty
        return _EMPTY.copy(), _EMPTY.copy()
    if impl == "host":
        return _host_oracle(probe_keys, build_keys)
    pk = _device_keys(probe_keys, dev)
    bk = _device_keys(build_keys, dev)
    lo = torch.searchsorted(bk, pk)
    hi = torch.searchsorted(bk, pk, right=True)
    cnt = (hi - lo).to(torch.int32)
    offs = torch.where(cnt > 0, lo, 0).to(torch.int32)
    total = int(cnt.sum(dtype=torch.int64))
    HOST_SYNCS.tick(site="hash_join_probe")
    check_int32_domain(total, dev, "sorted_probe_match")
    if total > 2**30:
        # pathological skew join on the CPU: int32 indices cannot
        # address the expansion — keep the exact int64 host oracle
        return _host_oracle(probe_keys, build_keys)
    if total == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return empty, empty
    order = torch.arange(n_build, dtype=torch.int32, device=dev)
    return _probe_expand_device(cnt, offs, order, total, impl)
