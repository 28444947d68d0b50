"""Segmented reduction oracles: the plain PyTorch version of the K5
kernel (``segment_reduce_torch``) and the exact numpy oracle (sort +
``reduceat``)."""
from __future__ import annotations

import numpy as np
import torch


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


def segment_reduce_torch(values: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int, op: str) -> torch.Tensor:
    """Plain version of the K5 kernel: (N,) int32/float32 values + (N,)
    int32 segment ids -> (num_segments,) sum/min/max at the values'
    dtype, identity-filled. Ids outside [0, num_segments) land in an
    overflow slot that is sliced off. NaN is taken out before the
    scatter and put back per segment, so min and max propagate it
    whatever the scatter does with NaN on the device; float min/max
    reduce order-preserving int keys, so signed zeros come out as the
    reference's (and the kernel's) do."""
    dt = torch.empty(0, dtype=values.dtype).numpy().dtype
    ident = np.asarray(reduce_identity(op, dt)).item()
    g = num_segments
    seg = segment_ids.to(torch.int64)
    idx = torch.where((seg >= 0) & (seg < g), seg, g)
    out = torch.full((g + 1,), ident, dtype=values.dtype,
                     device=values.device)
    if op == "sum":
        return out.index_add_(0, idx, values)[:g]
    if op not in ("min", "max"):
        raise ValueError(f"unsupported op {op!r}")
    if not values.is_floating_point():
        return out.scatter_reduce_(0, idx, values, reduce="a" + op,
                                   include_self=True)[:g]
    if values.dtype != torch.float32:
        raise TypeError(f"values: expected int32 or float32, got "
                        f"{values.dtype}")
    isnan = torch.isnan(values)
    values = torch.where(isnan, torch.full_like(values, ident), values)
    nan = torch.zeros(g + 1, dtype=torch.int32, device=values.device)
    nan.index_add_(0, idx, isnan.to(torch.int32))
    # reduce order-preserving int32 keys, so -0.0 < +0.0 whatever the
    # rows' order (min gives -0.0, max +0.0, as jax.ops.segment_* do)
    keys = _order_key(out.view(torch.int32)).scatter_reduce_(
        0, idx, _order_key(values.view(torch.int32)), reduce="a" + op,
        include_self=True)
    out = _order_key(keys).view(torch.float32)
    out = torch.where(nan > 0, torch.full_like(out, float("nan")), out)
    return out[:g]


def _order_key(bits: torch.Tensor) -> torch.Tensor:
    """float32 bits -> int32 keys in the floats' order (negative floats
    get their magnitude bits flipped); its own inverse."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)
