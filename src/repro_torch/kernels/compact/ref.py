"""Plain PyTorch scan + exact numpy oracle for ``compact_index``."""
from __future__ import annotations

import numpy as np
import torch


def prefix_count_torch(flags: torch.Tensor) -> torch.Tensor:
    """Plain version of the CUDA prefix-count kernel: (N,) int32 flags
    -> (N,) int32 inclusive running count (``cumsum(flags)``)."""
    return torch.cumsum(flags, 0).to(torch.int32)


def compact_index_np(valid) -> np.ndarray:
    """Exact numpy oracle for ``ops.compact_index``: validity mask ->
    ascending int64 indices of the True positions (``np.nonzero``)."""
    return np.nonzero(np.asarray(valid))[0].astype(np.int64)
