"""Shared helpers for the host-facing kernel wrappers."""
from __future__ import annotations

import numpy as np
import torch

IMPLS = ("auto", "kernel", "ref", "host")


def is_device_array(a) -> bool:
    """True for torch tensors (on any device); numpy arrays and
    host-side column wrappers are not."""
    return isinstance(a, torch.Tensor)


def as_device(device) -> torch.device:
    """``device`` (a string, ``torch.device`` or tensor) as a
    ``torch.device``; ``None`` is the CPU."""
    if isinstance(device, torch.Tensor):
        return device.device
    return torch.device("cpu" if device is None else device)


def resolve_impl(impl: str, fallback: str, device=None) -> str:
    """Resolve ``impl="auto"`` by where the data lives (``device``: a
    device or a tensor). On the CPU it is ``fallback`` — ``"host"`` for
    host-facing wrappers whose numpy oracle serves there, ``"ref"`` for
    tensor ops. On a CUDA device it is the kernel, and a card below
    compute capability 9.0, which cannot run the sm_90a kernels, raises:
    data on the card never drops to a plain version on its own. Other
    tokens pass through unchanged."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    dev = as_device(device)
    if dev.type != "cuda":
        return fallback
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise RuntimeError(
            f"{dev}: compute capability {cap[0]}.{cap[1]} cannot run the "
            f"port's sm_90a kernels (needs 9.0 or newer); pass "
            f"impl='ref' or 'host' to choose a plain version explicitly")
    return "kernel"


def check_int32_domain(total: int, device, what: str) -> None:
    """Raise when ``total`` output rows of device work on a CUDA device
    exceed what int32 indices address (2^30, the reference's skew
    guard). On the CPU the caller serves such an expansion from its
    exact int64 numpy oracle, as the reference does off the TPU."""
    if total > 2**30 and as_device(device).type == "cuda":
        raise RuntimeError(
            f"{what}: {total} output rows exceed the int32 index domain "
            f"of the device path (2^30)")


def to_numpy(a) -> np.ndarray:
    """Host copy of a tensor (``.cpu().numpy()``) or ``np.asarray`` of
    anything else. Does no sync accounting: callers tick
    ``HOST_SYNCS`` where the reference counts the fetch."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def np_dtype(a) -> np.dtype:
    """The numpy dtype of a tensor, numpy array or lazy column, read
    without fetching any data."""
    if isinstance(a, torch.Tensor):
        return torch.empty(0, dtype=a.dtype).numpy().dtype
    return np.dtype(a.dtype)
