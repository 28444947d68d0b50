"""Host-facing wrapper: device segment expansion (counts + offsets ->
gather indices).

``expand_segments`` is the device replacement for ``np.repeat``: the
equi-join probe expansion and the cross join's row enumeration both
reduce to it.

* ``impl="kernel"`` — scatter marks at segment starts, the CUDA
  running-sum scan for segment ids, gathers for positions;
* ``impl="ref"`` — the same formulation with ``torch.cumsum``;
* ``impl="host"`` — the exact ``np.repeat`` oracle (zero device work);
* ``impl="auto"`` — the kernel on a CUDA device, the host oracle on
  the CPU.

Device impls fetch the (seg_ids, positions) pair in ONE device→host
sync (site ``"expand"``), or in ZERO with ``as_device=True``, which
hands the tensors straight to the fused table gather; the host oracle
records a ``host_fallbacks["expand"]`` serving instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sync import HOST_SYNCS
from ..util import as_device as device_of
from ..util import check_int32_domain, resolve_impl
from .expand import running_segment_ids_kernel
from .ref import expand_segments_np, running_segment_ids_torch

_EMPTY = np.zeros(0, dtype=np.int64)


def segment_ids(starts: torch.Tensor, total: int, impl: str
                ) -> torch.Tensor:
    """Segment id of each of ``total`` output positions, given each
    segment's (N,) int32 output start: +1 marks scattered at the starts
    (empty segments collapse onto the next start; starts equal to
    ``total`` land in an overflow slot that is sliced off), then the
    running-sum scan."""
    marks = torch.zeros(total + 1, dtype=torch.int32, device=starts.device)
    marks.index_add_(0, starts.long(),
                     torch.ones_like(starts, dtype=torch.int32))
    marks = marks[:total]
    if impl == "ref":
        return running_segment_ids_torch(marks)
    return running_segment_ids_kernel(marks)


def _expand_device(starts: torch.Tensor, offsets: torch.Tensor, total: int,
                   impl: str):
    """Scatter + scan + gather over the (T,) output domain."""
    seg = segment_ids(starts, total, impl)
    iota = torch.arange(total, dtype=torch.int32, device=starts.device)
    within = iota - torch.index_select(starts, 0, seg)
    return seg, within + torch.index_select(offsets, 0, seg)


def expand_segments(counts, offsets=None, *, impl: str = "auto",
                    as_device: bool = False, device=None):
    """Expand per-segment ``counts`` (N,) into ``(seg_ids, positions)``
    gather indices over T = sum(counts) output rows.

    ``seg_ids[t]`` is the segment output row t belongs to
    (``np.repeat(arange(N), counts)``); ``positions[t]`` is
    ``offsets[seg_ids[t]]`` plus row t's rank within its segment
    (``offsets=None`` = all-zero offsets). int64 numpy outputs, or, with
    ``as_device=True`` on a device impl, int32 tensors on ``device``
    (the CPU when None) with no fetch at all.
    """
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = len(counts)
    offs = (None if offsets is None
            else np.ascontiguousarray(offsets, dtype=np.int64))
    if offs is not None and len(offs) != n:
        raise ValueError(f"offsets must match counts: {len(offs)} != {n}")
    total = int(counts.sum())
    if n == 0 or total == 0:
        return _EMPTY, _EMPTY.copy()
    dev = device_of(device)
    impl = resolve_impl(impl, "host", dev)
    if impl != "host":
        check_int32_domain(total, dev, "expand_segments")
    if impl == "host" or total > 2**30:
        # int32 device indices cannot address the expansion: on the CPU
        # a pathological skew-join expansion keeps the exact int64
        # oracle (on the card the check above raises)
        HOST_SYNCS.fallback("expand")
        return expand_segments_np(counts, offs)
    starts = np.cumsum(counts) - counts
    if offs is None:
        offs = np.zeros(n, dtype=np.int64)
    seg, pos = _expand_device(
        torch.as_tensor(starts.astype(np.int32), device=dev),
        torch.as_tensor(offs.astype(np.int32), device=dev), total, impl)
    if as_device:
        return seg, pos
    both = torch.stack([seg, pos]).cpu().numpy()
    HOST_SYNCS.tick(site="expand")
    return both[0].astype(np.int64), both[1].astype(np.int64)
