"""Exact numpy oracles for segmented reduction (sort + ``reduceat``).

The device segmented reduction (K5, the TPU's ``segment_reduce_kernel``)
is not ported yet; see ``ops.py``.
"""
from __future__ import annotations

import numpy as np


def reduce_identity(op: str, dtype):
    """Neutral element for ``op`` at ``dtype`` (empty segments yield
    it: ±inf for floats, iinfo extremes for ints)."""
    if op == "sum":
        return np.zeros((), dtype=dtype)[()]
    if np.issubdtype(dtype, np.floating):
        sign = 1.0 if op == "min" else -1.0
        return np.asarray(sign * np.inf, dtype=dtype)[()]
    info = np.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_reduce_np(values, segment_ids, num_segments: int, op: str):
    """Exact numpy segmented reduction, with the identity fill of empty
    segments."""
    values = np.asarray(values)
    seg = np.asarray(segment_ids)
    out = np.full(num_segments, reduce_identity(op, values.dtype),
                  dtype=values.dtype)
    if len(values) == 0 or num_segments == 0:
        return out
    order = np.argsort(seg, kind="stable")
    sseg = seg[order]
    sval = values[order]
    starts = np.nonzero(np.concatenate([[True], sseg[1:] != sseg[:-1]]))[0]
    ufunc = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    out[sseg[starts]] = ufunc.reduceat(sval, starts)
    return out
