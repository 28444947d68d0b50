"""Segmented-reduction ops for the relational path: the device
segmented reduction (``segment_reduce`` and its host-facing
``segment_reduce_host``/``segment_count``), the executor's grouping
toolkit (``SegmentPlan``, ``segmented_aggregate``) and the sort-based
equi join (``join_match_lists``).

* ``segment_reduce`` — tensor in, tensor out: the K5 CUDA kernel
  (``impl="kernel"``, and ``"auto"`` on a CUDA device), its plain torch
  version (``"ref"``, and ``"auto"`` on the CPU) or the numpy oracle
  (``"host"``);
* ``segment_reduce_host`` / ``segment_count`` — host-facing: numpy (or
  tensor) in, numpy out, one device→host fetch per call (site
  ``"segment_reduce"``). ``segment_count`` is the join-build histogram;
  ``impl="host"`` (and ``"auto"`` on the CPU) is ``np.bincount``;
* ``segmented_aggregate`` reduces int32/float32 min/max through
  ``segment_reduce_host`` on every impl but ``"host"``, everything that
  needs 64-bit accumulation on the host.

``join_match_lists`` groups the build side with ``group_build``
(narrow integer keys group by raw value: exact, representatives
ascending) and, on device impls, probes and expands the matches on the
device (``_probe_lookup_device`` + ``_probe_expand_device``, the latter
running the prefix-count and segment-id kernels) behind one scalar
fetch. Strings and floats take the shared host code space, whose build
histogram is ``segment_count`` (K5 on device impls).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compact.compact import prefix_count_kernel
from ..compact.ref import prefix_count_torch
from ..expand.ops import expand_segments, segment_ids
from ..hash_dedup.ops import group_build
from ..hash_dedup.ref import column_codes_np
from ..sync import HOST_SYNCS
from ..util import (
    as_device,
    check_int32_domain,
    is_device_array,
    np_dtype,
    resolve_impl,
    to_numpy,
)
from .ref import reduce_identity, segment_reduce_np, segment_reduce_torch
from .segmented_reduce import OPS, segment_reduce_kernel


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor, *,
                   num_segments: int, op: str = "sum",
                   impl: str = "auto") -> torch.Tensor:
    """(N,) values + (N,) int32 segment ids -> (num_segments,)
    reduction at the values' dtype, on the values' device. Empty
    segments yield the op's identity."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    impl = resolve_impl(impl, "ref", values)
    if impl == "host":
        out = segment_reduce_np(to_numpy(values), to_numpy(segment_ids),
                                num_segments, op)
        return torch.as_tensor(out, device=values.device)
    if impl == "ref":
        return segment_reduce_torch(values, segment_ids, num_segments, op)
    return segment_reduce_kernel(values, segment_ids, num_segments, op)


def _as_tensor(a, dev: torch.device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) \
        else torch.as_tensor(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype).contiguous()


def segment_reduce_host(values, segment_ids, num_segments: int,
                        op: str = "sum", *, impl: str = "auto",
                        device=None) -> np.ndarray:
    """Host-facing ``segment_reduce``: numpy or tensor inputs, a numpy
    result, ONE device→host fetch (site ``"segment_reduce"``). Host
    inputs go to ``device`` (the CPU when None); tensors stay where
    they are."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    dt = np_dtype(values)
    if num_segments == 0:
        return np.empty(0, dtype=dt)
    if int(np.shape(values)[0]) == 0:
        return np.full(num_segments, reduce_identity(op, dt), dtype=dt)
    dev = _device_of(values, segment_ids, device=device)
    impl = resolve_impl(impl, "ref", dev)
    v = _as_tensor(values, dev)
    seg = _as_tensor(segment_ids, dev, torch.int32)
    out = segment_reduce(v, seg, num_segments=num_segments, op=op,
                         impl=impl).cpu().numpy()
    HOST_SYNCS.tick(site="segment_reduce")
    return out


def segment_count(segment_ids, num_segments: int, *,
                  impl: str = "auto", device=None) -> np.ndarray:
    """Per-segment row counts as int64 (the join-build histogram).
    ``impl="host"`` (and ``"auto"`` on the CPU) is ``np.bincount``;
    the device impls sum ones with ``segment_reduce_host``."""
    dev = _device_of(segment_ids, device=device)
    impl = resolve_impl(impl, "host", dev)
    if impl == "host":
        return np.bincount(np.asarray(segment_ids),
                           minlength=num_segments).astype(np.int64)
    ones = torch.ones(int(np.shape(segment_ids)[0]), dtype=torch.int32,
                      device=dev)
    return segment_reduce_host(ones, segment_ids, num_segments, "sum",
                               impl=impl, device=dev).astype(np.int64)


# ------------------------------------------------------------------ grouping

def group_key_codes(key_columns: list) -> np.ndarray:
    """Encode arbitrary-dtype group-key columns as an (N, C) int32 code
    matrix (the exact host oracle of ``group_build_columns``)."""
    return column_codes_np(key_columns)


@dataclass(frozen=True)
class SegmentPlan:
    """Host grouping plan shared by every aggregate column of one
    group-by: ``seg`` assigns each row its group id, ``order`` is the
    stable sort by group, ``starts``/``counts`` delimit the segments."""

    seg: np.ndarray
    num_groups: int
    counts: np.ndarray
    order: np.ndarray
    starts: np.ndarray


def make_segment_plan(seg, num_groups: int) -> SegmentPlan:
    """Derive a ``SegmentPlan`` from raw group ids on the host."""
    seg = np.asarray(seg)
    counts = np.bincount(seg, minlength=num_groups).astype(np.int64)
    order = np.argsort(seg, kind="stable")
    starts = np.zeros(num_groups, dtype=np.int64)
    if num_groups:
        np.cumsum(counts[:-1], out=starts[1:])
    return SegmentPlan(seg=seg, num_groups=num_groups, counts=counts,
                       order=order, starts=starts)


def segment_plan_from_group_build(gb) -> SegmentPlan:
    """Adopt a ``group_build`` result as a ``SegmentPlan``: its
    ``order`` is the stable sort of rows by group id, and
    ``starts``/``counts`` already delimit the segments."""
    return SegmentPlan(seg=gb.group_ids, num_groups=gb.num_groups,
                       counts=gb.counts, order=gb.order, starts=gb.starts)


_DEVICE_DTYPES = (np.dtype(np.int32), np.dtype(np.float32))


def segmented_aggregate(plan: SegmentPlan, values, func: str, *,
                        impl: str = "auto") -> np.ndarray:
    """One segmented pass over all groups for one aggregate column.

    Exactness contract: count is integral int64; integer sum
    accumulates in int64; float sum and avg accumulate in float64;
    min/max preserve the column dtype (strings included) and propagate
    NaN. int32/float32 min/max reduce through ``segment_reduce_host``
    (K5 on device impls) on every impl but ``"host"``, a device column
    staying where it is; count/sum/avg and host-dtype min/max reduce on
    the host (a device column is fetched, ticked under
    ``"agg_values"``). Every group must be non-empty.
    """
    if func == "count":
        return plan.counts
    if func in ("min", "max") and impl != "host" \
            and np_dtype(values) in _DEVICE_DTYPES \
            and plan.num_groups > 0:
        return segment_reduce_host(values, plan.seg, plan.num_groups, func,
                                   impl=impl)
    if is_device_array(values):
        HOST_SYNCS.tick(site="agg_values")
    v = to_numpy(values)
    if plan.num_groups == 0:
        if func in ("min", "max"):
            return np.empty(0, dtype=v.dtype)
        if func != "avg" and v.dtype.kind in "biu":
            return np.zeros(0, dtype=np.int64)
        return np.zeros(0, dtype=np.float64)
    if func in ("min", "max"):
        if v.dtype.kind in "biufc":
            ufunc = np.minimum if func == "min" else np.maximum
            return ufunc.reduceat(v[plan.order], plan.starts)
        # strings / objects: sort within segments and take the boundary
        # element of each
        order2 = np.lexsort((v, plan.seg))
        idx = plan.starts if func == "min" else plan.starts + plan.counts - 1
        return v[order2[idx]]
    sorted_v = v[plan.order]
    if func == "sum":
        acc = sorted_v.astype(
            np.int64 if v.dtype.kind in "bui" else np.float64)
        return np.add.reduceat(acc, plan.starts)
    if func == "avg":
        sums = np.add.reduceat(sorted_v.astype(np.float64), plan.starts)
        return sums / plan.counts
    raise ValueError(f"unsupported aggregate {func!r}")


# ---------------------------------------------------------------------- join

def encode_join_keys(probe_keys, build_keys
                     ) -> tuple[np.ndarray, np.ndarray, int]:
    """Shared sorted code space over both join sides (order-isomorphic
    to the values; NaN collapses to the top code)."""
    n_probe = len(probe_keys)
    both = np.concatenate([np.asarray(probe_keys), np.asarray(build_keys)])
    uniq, codes = np.unique(both, return_inverse=True)
    codes = codes.astype(np.int32)
    return codes[:n_probe], codes[n_probe:], len(uniq)


def _device_of(*cols, device=None) -> torch.device:
    for c in cols:
        if isinstance(c, torch.Tensor):
            return c.device
    return as_device(device)


def join_match_lists(probe_keys, build_keys, *, impl: str = "auto",
                     device=None):
    """Equi-join match lists from a grouped build side.

    Narrow integer keys take the device build + probe
    (``_join_match_device``); strings and floats fall back to the
    shared host code space. Output ordering is identical either way:
    probe-major, and within one probe row the build matches in stable
    build-key sort order. Device impls return int32 tensors on the
    keys' device (``device`` when both are host), the host paths int64
    numpy arrays.
    """
    dev = _device_of(probe_keys, build_keys, device=device)
    n_probe, n_build = int(np.shape(probe_keys)[0]), \
        int(np.shape(build_keys)[0])
    if n_probe == 0 or n_build == 0:
        if resolve_impl(impl, "host", dev) != "host":
            # device empties keep the joined gather on its device path
            dev_empty = torch.zeros(0, dtype=torch.int32, device=dev)
            return dev_empty, dev_empty
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty
    pk, bk = probe_keys, build_keys
    pk_dt, bk_dt = np_dtype(pk), np_dtype(bk)
    if pk_dt == bk_dt and pk_dt.kind in "iub" and pk_dt.itemsize <= 4:
        def cast(a):
            if isinstance(a, torch.Tensor):
                return a.to(torch.int32)
            return np.asarray(a).astype(np.int32)
        return _join_match_device(cast(pk), cast(bk), impl=impl, device=dev)
    # host code-space fallback: fetching a device key column is a sync
    for a in (pk, bk):
        if is_device_array(a):
            HOST_SYNCS.tick(site="join_keys")
    probe_codes, build_codes, num_codes = encode_join_keys(
        to_numpy(pk), to_numpy(bk))
    counts_by_code = segment_count(build_codes, num_codes, impl=impl,
                                   device=dev)
    build_order = np.argsort(build_codes, kind="stable")
    offsets = np.zeros(num_codes, dtype=np.int64)
    np.cumsum(counts_by_code[:-1], out=offsets[1:])
    cnt = counts_by_code[probe_codes]
    return _expand_matches(cnt, build_order, offsets[probe_codes], impl=impl,
                           device=dev)


def _probe_lookup_device(rep_keys: torch.Tensor, counts: torch.Tensor,
                         starts: torch.Tensor, pk: torch.Tensor):
    """searchsorted over the ascending representative keys, fused with
    the per-probe count/offset lookup: (cnt, offs) int32 per probe row
    plus the exact int64 match total (a 0-d tensor)."""
    g = rep_keys.shape[0]
    pos = torch.searchsorted(rep_keys, pk)
    pos_c = torch.clamp(pos, max=g - 1)
    matched = rep_keys[pos_c] == pk
    cnt = torch.where(matched, counts[pos_c], 0)
    offs = torch.where(matched, starts[pos_c], 0)
    return cnt, offs, cnt.sum(dtype=torch.int64)


def _probe_expand_device(cnt: torch.Tensor, offs: torch.Tensor,
                         order: torch.Tensor, total: int, impl: str):
    """Match expansion over the (T,) output domain, entirely on the
    device: each probe's output start is the exclusive running sum of
    the counts (the prefix-count kernel), segment ids come from the
    running-sum scan, and gathers finish the build rows."""
    incl = prefix_count_torch(cnt) if impl == "ref" \
        else prefix_count_kernel(cnt)
    out_starts = incl - cnt
    seg = segment_ids(out_starts, total, impl)
    iota = torch.arange(total, dtype=torch.int32, device=cnt.device)
    within = iota - torch.index_select(out_starts, 0, seg)
    pos = within + torch.index_select(offs, 0, seg)
    return seg, torch.index_select(order, 0, pos)


def _join_match_device(pk, bk, *, impl: str = "auto", device=None):
    """Device build table + device probe.

    ``group_build`` on the raw key column (C == 1 sorts by value, so
    grouping is exact and representatives come back ascending by key);
    on device impls the representative searchsorted, the count/offset
    lookup and the match expansion run on the device — ONE scalar
    device→host sync for the output total (site ``"join_probe"``),
    int32 index tensors out. ``impl="host"`` keeps the exact host
    searchsorted + ``np.repeat`` oracle, recorded as a
    ``host_fallbacks["join_probe"]`` serving."""
    dev = as_device(device)
    impl = resolve_impl(impl, "host", dev)
    if is_device_array(bk):
        HOST_SYNCS.tick(site="join_build_keys")
    bk_np = np.ascontiguousarray(to_numpy(bk), dtype=np.int32)
    gb = group_build(bk_np[:, None], impl=impl, device=dev)
    rep_keys = bk_np[gb.reps]  # ascending by construction
    if impl != "host":
        pk_dev = pk.to(dev) if isinstance(pk, torch.Tensor) \
            else torch.as_tensor(np.asarray(pk), device=dev)
        cnt, offs, total = _probe_lookup_device(
            torch.as_tensor(rep_keys, device=dev),
            torch.as_tensor(gb.counts.astype(np.int32), device=dev),
            torch.as_tensor(gb.starts.astype(np.int32), device=dev),
            pk_dev.contiguous())
        total = int(total)
        HOST_SYNCS.tick(site="join_probe")
        check_int32_domain(total, dev, "join_match_lists")
        if total <= 2**30:
            if total == 0:
                empty = torch.zeros(0, dtype=torch.int32, device=dev)
                return empty, empty
            order = torch.as_tensor(gb.order.astype(np.int32), device=dev)
            return _probe_expand_device(cnt, offs, order, total, impl)
        # > 2^30 output rows on the CPU: int32 indices cannot address
        # the expansion — keep the exact int64 host oracle
    HOST_SYNCS.fallback("join_probe")
    pk_np = to_numpy(pk)
    pos = np.searchsorted(rep_keys, pk_np)
    pos_c = np.minimum(pos, gb.num_groups - 1)
    matched = rep_keys[pos_c] == pk_np
    gid = np.where(matched, pos_c, 0)
    cnt = np.where(matched, gb.counts[gid], 0)
    return _expand_matches(cnt, gb.order, gb.starts[gid], impl=impl,
                           device=dev)


def _expand_matches(cnt: np.ndarray, build_order: np.ndarray,
                    probe_offsets: np.ndarray, *, impl: str = "auto",
                    device=None):
    """Expand per-probe match counts into (out_probe, out_build) index
    lists: probe-major, build rows in segment (stable) order."""
    out_probe, pos = expand_segments(cnt, probe_offsets, impl=impl,
                                     device=device)
    if len(out_probe) == 0:
        return out_probe, pos
    return out_probe, build_order[pos]
