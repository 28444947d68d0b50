"""Logical-axis sharding policy (the reference's
``src/repro/sharding/policy.py``, on PyTorch).

Parameters, caches and activations are annotated with *logical* axis
names; a ``ShardingPolicy`` maps them onto the axes of a model mesh
(``launch/mesh.py::ModelMesh``):

    batch    -> data-parallel axes ('pod','data') / ('data',)
    embed    -> FSDP shard of d_model-like dims (params only)
    heads    -> tensor-parallel 'model'
    kv_heads -> 'model' when ``shard_kv_heads``, else replicated
    mlp/vocab/expert -> 'model' (TP / EP)
    seq      -> 'model' when sequence parallelism is on (activations)
    layers / conv / state / None -> replicated

``spec`` returns the port's own ``PartitionSpec`` (a tuple with one
entry per tensor dimension: None, a mesh axis name, or a tuple of
them), equal entry for entry to the reference's. ``named_sharding``
returns a ``Placement`` (a mesh and a spec), the counterpart of
``jax.sharding.NamedSharding``. Placement is explicit in the port:
``models/params.py::shard_params`` splits a tree over the mesh and the
layers loop over its shards (``sharding/model.py``), so ``shard`` (the
reference's ``with_sharding_constraint``) has nothing to constrain and
returns its input.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis
    name, or a tuple of mesh axis names (split over their product,
    row-major), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class Placement:
    """A mesh and a spec: where each shard of a tensor lives (the
    reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


@dataclass(frozen=True)
class ShardingPolicy:
    mesh: Optional[Any] = None
    dp_axes: tuple = ("data",)
    fsdp_axes: tuple = ("data",)
    tp_axis: Optional[str] = "model"
    shard_kv_heads: bool = True
    seq_parallel: bool = False
    # FSDP over params: when False, 'embed' maps to None (pure TP+DP)
    fsdp_params: bool = True
    # serving-mode knobs:
    # shard KV/latent caches along the sequence dim over the TP axis
    shard_cache_seq: bool = False
    # MoE expert-parallelism over (data x model) instead of model only
    ep_over_dp: bool = False
    # small-model mode: pure data parallelism across BOTH mesh axes
    dp_over_tp: bool = False

    # ------------------------------------------------------------------
    @staticmethod
    def single() -> "ShardingPolicy":
        return ShardingPolicy(mesh=None)

    @staticmethod
    def for_mesh(mesh, *, shard_kv_heads: bool = True,
                 seq_parallel: bool = False,
                 fsdp_params: bool = True) -> "ShardingPolicy":
        names = mesh.axis_names
        dp = tuple(a for a in names if a in ("pod", "data"))
        tp = "model" if "model" in names else None
        return ShardingPolicy(mesh=mesh, dp_axes=dp, fsdp_axes=dp,
                              tp_axis=tp, shard_kv_heads=shard_kv_heads,
                              seq_parallel=seq_parallel,
                              fsdp_params=fsdp_params)

    def replace(self, **kw) -> "ShardingPolicy":
        return replace(self, **kw)

    # ------------------------------------------------------------------
    def _map_axis(self, name: Optional[str]):
        if name is None:
            return None
        if self.dp_over_tp:
            if name == "batch":
                axes = tuple(self.dp_axes) + ((self.tp_axis,)
                                              if self.tp_axis else ())
                return axes if len(axes) > 1 else (axes[0] if axes else None)
            return None  # nothing else is sharded in pure-DP mode
        if name == "batch":
            return self.dp_axes if len(self.dp_axes) > 1 else (
                self.dp_axes[0] if self.dp_axes else None)
        if name == "embed":
            if not self.fsdp_params:
                return None
            return self.fsdp_axes if len(self.fsdp_axes) > 1 else (
                self.fsdp_axes[0] if self.fsdp_axes else None)
        if name == "expert":
            if self.ep_over_dp and self.dp_axes and self.tp_axis:
                return tuple(self.dp_axes) + (self.tp_axis,)
            return self.tp_axis
        if name in ("heads", "mlp", "vocab"):
            return self.tp_axis
        if name == "kv_heads":
            return self.tp_axis if self.shard_kv_heads else None
        if name == "seq":
            return self.tp_axis if self.seq_parallel else None
        if name == "kv_seq":
            return self.tp_axis if self.shard_cache_seq else None
        # 'layers', 'head_dim', 'state', 'conv', ... stay replicated
        return None

    def spec(self, *axes: Optional[str]) -> PartitionSpec:
        return PartitionSpec(*[self._map_axis(a) for a in axes])

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def shard(self, x, *axes: Optional[str]):
        """The reference constrains an activation's sharding here; the
        port places every shard explicitly (``sharding/model.py``), so
        this returns ``x`` unchanged, on a mesh or off it."""
        return x

    def named_sharding(self, *axes: Optional[str]) -> Optional[Placement]:
        if self.mesh is None:
            return None
        return Placement(self.mesh, self.spec(*axes))

    # axis sizes (1 when mesh is absent) --------------------------------
    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]

    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        if self.dp_over_tp and self.tp_axis:
            n *= self.mesh.shape[self.tp_axis]
        return n


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def spec_tree(axes_tree, policy: ShardingPolicy):
    """Map a tree (nested dicts) of logical-axis tuples to
    PartitionSpecs."""
    if isinstance(axes_tree, dict):
        return {k: spec_tree(v, policy) for k, v in axes_tree.items()}
    if _is_axes(axes_tree):
        return policy.spec(*axes_tree)
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(spec_tree(v, policy) for v in axes_tree)
    return axes_tree
