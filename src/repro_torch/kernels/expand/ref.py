"""Plain PyTorch scan + exact numpy oracle for ``expand_segments``."""
from __future__ import annotations

import numpy as np
import torch


def running_segment_ids_torch(marks: torch.Tensor) -> torch.Tensor:
    """Plain version of the CUDA running-sum kernel: (T,) int32 marks
    -> (T,) int32 segment ids (``cumsum(marks) - 1``)."""
    return (torch.cumsum(marks, 0) - 1).to(torch.int32)


def expand_segments_np(counts, offsets=None):
    """Exact numpy oracle for ``ops.expand_segments``: per-segment
    ``counts`` (N,) -> ``(seg_ids, positions)`` over T = sum(counts)
    output rows, where ``seg_ids`` repeats each segment index
    count-many times and ``positions[t]`` is ``offsets[seg] + <rank of
    t within its segment>`` (``offsets=None`` means all-zero)."""
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = len(counts)
    total = int(counts.sum())
    seg = np.repeat(np.arange(n, dtype=np.int64), counts)
    first = np.cumsum(counts) - counts
    within = np.arange(total, dtype=np.int64) - np.repeat(first, counts)
    if offsets is None:
        return seg, within
    pos = np.ascontiguousarray(offsets, dtype=np.int64)[seg] + within
    return seg, pos
