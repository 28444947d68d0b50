"""Model meshes (the reference's ``src/repro/launch/mesh.py``, on
PyTorch).

Single pod:  (16, 16)       axes ('data', 'model')          = 256 devices
Multi-pod :  (2, 16, 16)    axes ('pod', 'data', 'model')   = 512 devices

A ``ModelMesh`` is a numpy object array of ``torch.device``s with axis
names, the counterpart of ``jax.sharding.Mesh``: ``shape`` maps each
axis name to its size, ``size`` is the device count, ``devices`` the
array. There are no axis types: the port places every shard itself
(``sharding/model.py``).

No silent fallback: without ``devices=`` a mesh takes the first
dp·tp·pods visible CUDA cards, one per position, and raises when there
are fewer. A device may repeat only when the caller passes ``devices=``
(``["cpu"] * 4`` in the tests, ``[card] * 4`` to put every shard on one
card), as ``sharding/data.py::make_data_mesh`` allows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class ModelMesh:
    """Devices laid out over named axes (see module doc)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"ModelMesh: {devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shared(self) -> bool:
        """True when every position lies on one device."""
        return len({str(d) for d in self.devices.flat}) == 1

    def __repr__(self) -> str:
        return (f"ModelMesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _devices(n: int, devices: Optional[Sequence]) -> list:
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"make_mesh: the mesh has {n} positions, "
                             f"devices= gives {len(devs)}")
        return devs
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise RuntimeError(
            f"make_mesh: the mesh needs {n} CUDA devices, found {found}; "
            f"pass devices= to build it elsewhere (e.g. devices=['cpu'] * "
            f"{n}, or one card repeated)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(dp: int = 1, tp: int = 1, pods: int = 1,
              devices: Optional[Sequence] = None) -> ModelMesh:
    """Elastic mesh constructor used by the launchers: (dp, tp) over
    ('data', 'model'), or (pods, dp, tp) over ('pod', 'data', 'model')
    when ``pods`` > 1."""
    for name, n in (("dp", dp), ("tp", tp), ("pods", pods)):
        if n < 1:
            raise ValueError(f"make_mesh: {name} must be >= 1, got {n}")
    shape = (pods, dp, tp) if pods > 1 else (dp, tp)
    axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = _devices(devs.size, devices)
    return ModelMesh(devs.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> ModelMesh:
    """The reference's production layouts, (16, 16) or (2, 16, 16): no
    host here has 256 or 512 cards, so ``devices=`` must name every
    position."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = int(np.prod(shape))
    if devices is None or len(devices) != n:
        raise ValueError(f"make_production_mesh: pass devices= with {n} "
                         f"entries (got "
                         f"{None if devices is None else len(devices)})")
    if multi_pod:
        return make_mesh(16, 16, pods=2, devices=devices)
    return make_mesh(16, 16, devices=devices)


def single_device_mesh(device="cuda") -> ModelMesh:
    """A (1, 1) mesh over ``device``."""
    return make_mesh(1, 1, devices=[device])
