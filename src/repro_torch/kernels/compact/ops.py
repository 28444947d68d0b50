"""Host-facing wrappers: device stream compaction and the fused column
gather.

``compact_index`` turns a validity mask into the dense gather index of
its live rows (the device analogue of ``np.nonzero``):

* ``impl="kernel"`` — the CUDA prefix count (``compact.py``), then one
  scatter of the live rows' indices into their output positions;
* ``impl="ref"`` — the same formulation with ``torch.cumsum``;
* ``impl="host"`` — the exact ``np.nonzero`` oracle (zero device work);
* ``impl="auto"`` — the kernel on a CUDA device, the host oracle on
  the CPU.

Device impls keep the index on the mask's device. A known ``count``
makes the call sync-free; otherwise the live total is fetched as one
scalar, ticked under site ``"compact"``. The host oracle records a
``host_fallbacks["compact"]`` serving instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sync import HOST_SYNCS
from ..util import resolve_impl, to_numpy
from .compact import prefix_count_kernel
from .ref import compact_index_np, prefix_count_torch

_EMPTY = np.zeros(0, dtype=np.int64)


def _compact_index_device(mask: torch.Tensor, impl: str):
    """Prefix count + scatter over an (N,) bool mask. Returns the (N,)
    int32 dense gather index (positions >= the live total hold
    garbage) and the live total as a 0-d tensor. Dead rows scatter to
    an overflow slot N that is sliced off, so no index filter (and no
    data-dependent shape) is needed."""
    n = mask.shape[0]
    flags = mask.to(torch.int32)
    psum = (prefix_count_torch(flags) if impl == "ref"
            else prefix_count_kernel(flags))
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    dest = torch.where(mask, psum - 1, n).long()
    idx = torch.zeros(n + 1, dtype=torch.int32, device=mask.device)
    idx[dest] = iota
    return idx[:n], psum[-1]


def compact_index(valid, *, count: int | None = None, impl: str = "auto"):
    """Dense gather index of the True positions of ``valid`` (N,) bool.

    Returns ``(idx, count)``: ``idx[j]`` is the row index of the j-th
    live row (ascending). Device impls return an int32 tensor on the
    mask's device; ``impl="host"`` returns int64 numpy indices.
    """
    n = int(np.shape(valid)[0])
    impl = resolve_impl(impl, "host", valid)
    if n == 0:
        return _EMPTY, 0
    if impl == "host":
        HOST_SYNCS.fallback("compact")
        idx = compact_index_np(to_numpy(valid))
        return idx, len(idx)
    mask = valid if isinstance(valid, torch.Tensor) \
        else torch.as_tensor(np.asarray(valid))
    idx, count_dev = _compact_index_device(mask.bool(), impl)
    if count is None:
        count = int(count_dev)
        HOST_SYNCS.tick(site="compact")
    return idx[:count], count


def device_gather(cols, idx) -> list:
    """Gather every column in ``cols`` (1-D tensors of equal length, on
    one device) through ``idx`` with no device→host sync. A host index
    is uploaded to the columns' device."""
    if not cols:
        return []
    dev = cols[0].device
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int32)
    idx = idx.to(dev)
    return [torch.index_select(c, 0, idx) for c in cols]
