"""Atomic, asynchronous checkpoints, the reference's
``src/repro/training/checkpoint.py`` on PyTorch, with its on-disk
layout, so a checkpoint written by either package restores in the
other:

* ``step_%010d/`` holds one ``a.b.c.npy`` per leaf of the flattened
  tree and a ``manifest.json`` with ``step``, the sorted ``keys``,
  ``time`` and the caller's extras;
* **atomic**: writes go to ``step_<n>.tmp/`` and are renamed only after
  the manifest is fsync'd, so a killed writer never corrupts the
  latest checkpoint, and a stale ``.tmp`` is never listed;
* **async**: ``save_async`` copies the tree to the host at once and
  writes on a thread, so the train loop does not wait on the disk;
* old steps beyond ``keep`` are deleted after each write.

Leaves are tensors on any device, numpy arrays, numbers, or the
``Sharded`` leaves of a tree laid out over a model mesh, which are
written as their global arrays (each distinct slice copied to the host
once), under the same keys. A bfloat16 tensor (bf16 optimizer moments)
is stored as the raw two-byte ``<V2`` words ``np.save`` writes for the
reference's bfloat16 arrays; ``restore(device=...)`` reads such a leaf
back as bfloat16.

``restore(policy=, cfg=)`` is the counterpart of the reference's
``shardings=``: it lays a ``launch/train`` tree (``{"params", "opt"}``)
out over the policy's mesh, whatever mesh wrote it (elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.params import shard_params
from ..sharding import model as sm
from .optimizer import shard_state, tree_map


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_host(v) -> np.ndarray:
    """A host copy of ``v``, never a view: the caller's tensors go on
    changing in place while an async save writes. A ``Sharded`` leaf is
    copied as its global array."""
    if isinstance(v, sm.Sharded):
        v = v.unshard("cpu")
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", copy=True)
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.array(v)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.dtype("V2"):
        return torch.as_tensor(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a).to(device)  # keeps 0-d leaves 0-d


class CheckpointManager:
    """Checkpoints under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: dict, extra: Optional[dict] = None):
        """Write ``tree`` as ``step`` now (a step already on disk is
        kept as it is)."""
        self.wait()  # never race an in-flight async save of the same step
        if step in self.all_steps():
            return
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self._write(step, host, extra or {})

    def save_async(self, step: int, tree: dict,
                   extra: Optional[dict] = None):
        """Copy ``tree`` to the host now and write it on a thread."""
        self.wait()  # one in-flight save at a time
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                self._write(step, host, extra or {})
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: dict, extra: dict):
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for k, v in host.items():
            np.save(tmp / (k + ".npy"), v)
        manifest = {
            "step": step,
            "keys": sorted(host.keys()),
            "time": time.time(),
            **extra,
        }
        mpath = tmp / "manifest.json"
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """The published steps, oldest first (never a ``.tmp``)."""
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and \
                    not p.name.endswith(".tmp"):
                if (p / "manifest.json").exists():
                    out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest published step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None, *,
                policy=None, cfg=None) -> tuple[dict, dict]:
        """(tree, manifest) of ``step`` (default the latest): numpy
        arrays, or tensors on ``device`` when one is given. Under an
        active ``policy`` (``cfg`` the model's configuration) the tree
        of ``launch/train`` is laid out over the policy's mesh: its
        ``"params"`` by ``shard_params``, the moments of its ``"opt"``
        beside them by ``state_specs`` (``optimizer.shard_state``), every
        other leaf on the mesh's first device; ``device`` is unused."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {k: np.load(d / (k + ".npy")) for k in manifest["keys"]}
        if sm.on_mesh(policy):
            return _lay_out(_unflatten(flat), policy, cfg), manifest
        if device is not None:
            flat = {k: _to_device(v, device) for k, v in flat.items()}
        return _unflatten(flat), manifest


def _lay_out(tree: dict, policy, cfg) -> dict:
    """A restored tree of host arrays over ``policy``'s mesh
    (``CheckpointManager.restore``)."""
    if cfg is None:
        raise ValueError("restore(policy=...) needs cfg=, the model's "
                         "configuration, to lay the parameters out")
    host = tree_map(lambda a: _to_device(a, "cpu"), tree)
    home = sm.home_device(policy)
    out = {k: tree_map(lambda t: t.to(home), v) if isinstance(v, dict)
           else v.to(home) for k, v in host.items()
           if k not in ("params", "opt")}
    if "params" in host:
        out["params"] = shard_params(cfg, host["params"], policy)
    if "opt" in host:
        out["opt"] = shard_state(host["opt"], out["params"])
    return out
