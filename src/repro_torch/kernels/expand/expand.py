"""K4, the running segment ids, as a CUDA kernel (``csrc/expand.cu``).

Replaces ``src/repro/kernels/expand/expand.py::running_segment_ids_kernel``.
The TPU kernel carries the running mark total across its sequential
grid in SMEM; on Hopper the carry is a device-wide three-phase scan
(``csrc/scan.cuh``). Memory-bound: 8 bytes per element.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import running_segment_ids_torch


def running_segment_ids_kernel(marks: torch.Tensor) -> torch.Tensor:
    """(T,) int32 marks (+k where k segments start, 0 elsewhere) ->
    (T,) int32 segment ids (inclusive running sum minus one). Launches
    the CUDA kernel for a CUDA tensor; a CPU tensor takes the plain
    version."""
    if marks.device.type != "cuda":
        return running_segment_ids_torch(marks)
    _build.check_cuda(marks, "marks", torch.int32, 1)
    n = marks.shape[0]
    out = torch.empty_like(marks)
    if n == 0:
        return out
    scratch = _build.scan_scratch(n, marks)
    _build.call("repro_running_segment_ids", marks.device, _build.ptr(marks),
                _build.ptr(out), _build.ptr(scratch), n,
                _build.stream(marks))
    _build.count_launch("running_segment_ids", marks.shape)
    return out
