"""K5, the segmented reduction, as a CUDA kernel
(``csrc/segment_reduce.cu``).

Replaces ``src/repro/kernels/segmented_reduce/segmented_reduce.py::
segment_reduce_kernel``, which compares every row with every segment of
a tile (O(N*G) dense work). On Hopper each row is combined into its
segment once with an atomic, in one memset and one launch: every
accumulator is a 32-bit word whose identity is the zero word (int32 and
float32 sums as they are; min/max as biased order-preserving int32 keys,
NaN keyed beyond ±inf so it propagates), so the memset fills the output,
and the last block to arrive on a counter decodes min/max words in
place. Float32 sums use float atomicAdd (run-to-run order varies;
tolerance ``count * 2^-23 * sum|v|``). Each thread issues a batch of
16-byte id and value loads before it reads any; small segment counts
pre-reduce in shared memory per block. Memory-bound: 8N + 4G bytes.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import segment_reduce_torch

OPS = ("sum", "min", "max")
_DTYPES = (torch.int32, torch.float32)


def segment_reduce_kernel(values: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int, op: str = "sum"
                          ) -> torch.Tensor:
    """(N,) int32/float32 values + (N,) int32 segment ids (any order;
    ids outside [0, num_segments) are dropped) -> (num_segments,)
    sum/min/max at the values' dtype; an empty segment holds the op's
    identity. Launches the CUDA kernel for CUDA tensors; CPU tensors
    take the plain version."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if values.device.type != "cuda":
        return segment_reduce_torch(values, segment_ids, num_segments, op)
    if values.dtype not in _DTYPES:
        raise TypeError(f"values: expected int32 or float32, got "
                        f"{values.dtype}")
    _build.check_cuda(values, "values", values.dtype, 1)
    _build.check_cuda(segment_ids, "segment_ids", torch.int32, 1)
    if segment_ids.shape != values.shape:
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} must "
                         f"match values {tuple(values.shape)}")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"num_segments out of range: {num_segments}")
    if num_segments == 0:
        return torch.empty(0, dtype=values.dtype, device=values.device)
    n = values.shape[0]
    # the output, then the kernel's arrival counter
    buf = torch.empty(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    _build.call("repro_segment_reduce", values.device, _build.ptr(values),
                _build.ptr(segment_ids), _build.ptr(buf), n, num_segments,
                OPS.index(op), int(values.dtype == torch.float32),
                _build.stream(values))
    _build.count_launch("segment_reduce", (n, num_segments))
    return buf[:num_segments]
