"""The train step: microbatched gradient accumulation, per-layer
remat and the AdamW update, the reference's
``src/repro/training/train_step.py`` on PyTorch.

``build_train_step(cfg, opt_cfg, num_microbatches, remat, accum_dtype,
policy=)`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``. The reference's ``lax.scan`` over microbatches
is a loop (activation memory ∝ one microbatch); its donated buffers are
the in-place update of ``params`` and ``opt_state``.

Under an active ``policy`` (``params`` from ``shard_params``, the state
from ``init_state`` over them) every distinct part of the ``Sharded``
leaves is an autograd leaf: the loss is the mesh's global loss
(``forward_loss(policy=)``), the gradients come back laid out as the
parameters, and the gradients of replicated slices are summed over
their holders (``sharding.model.sum_replicas``) before the update, the
counterpart of the reference's GSPMD gradient all-reduce.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import forward_loss
from ..models.config import ModelConfig
from ..models.lm import _check_mesh as check_mesh
from ..sharding import model as sm
from ..sharding.policy import ShardingPolicy
from .optimizer import AdamWConfig, apply_updates, leaves, tree_map


def _split_batch(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...) for every leaf."""
    def r(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"{n} microbatches")
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    return {k: r(v) for k, v in batch.items()}


def _tensors(leaf) -> list:
    """A leaf's tensors: itself, or each distinct part of a
    ``Sharded``."""
    if isinstance(leaf, sm.Sharded):
        return [part for _, part in leaf.distinct()]
    return [leaf]


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                   remat: Optional[str] = None, *,
                   policy: Optional[ShardingPolicy] = None):
    """(loss, grads) of ``forward_loss``, grads in the tree of
    ``params`` (a ``Sharded`` leaf's laid out as it, each distinct part
    an autograd leaf; replicas are not yet summed). A leaf the loss does
    not reach (the SSM family's ``ln2``, which feeds nothing) gets
    zeros, as ``jax.grad`` gives."""
    flat = [t for _, p in leaves(params) for t in _tensors(p)]
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = forward_loss(cfg, params, batch, remat=remat, policy=policy)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    grad_of = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)}

    def grad(p):
        if isinstance(p, sm.Sharded):
            return p.map(lambda part: grad_of[id(part)])
        return grad_of[id(p)]

    return loss.detach(), tree_map(grad, params)


def _to(leaf, dtype):
    if isinstance(leaf, sm.Sharded):
        return leaf.map(lambda t: t.to(dtype), dtype)
    return leaf.to(dtype)


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     num_microbatches: int = 1,
                     remat: Optional[str] = "full",
                     accum_dtype: torch.dtype = torch.float32, *,
                     policy: Optional[ShardingPolicy] = None):
    """The step: the loss and gradients of each microbatch (the batch
    split as ``_split_batch`` splits it: microbatch k is rows [k·B/n,
    (k+1)·B/n) of the global batch, scattered over the data ranks by
    ``forward_loss``), gradients summed in ``accum_dtype`` and divided
    by the count, the mean loss, then (over a mesh, after
    ``sum_replicas``) ``apply_updates``. Metrics: ``loss``,
    ``grad_norm`` and the new ``step``, over a mesh on its first
    device."""
    mesh = sm.on_mesh(policy)
    if mesh:
        check_mesh(cfg, policy)

    def step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, grads = value_and_grad(cfg, params, batch, remat,
                                         policy=policy)
        else:
            mbs = _split_batch(batch, num_microbatches)
            grads, losses = None, []
            for i in range(num_microbatches):
                loss_i, g = value_and_grad(
                    cfg, params, {k: v[i] for k, v in mbs.items()}, remat,
                    policy=policy)
                losses.append(loss_i)
                if grads is None:
                    grads = tree_map(lambda v: _to(v, accum_dtype), g)
                else:
                    for (_, a), (_, b) in zip(leaves(grads), leaves(g)):
                        for ta, tb in zip(_tensors(a), _tensors(b)):
                            ta.add_(tb.to(accum_dtype))
                del g
            for _, a in leaves(grads):
                for t in _tensors(a):
                    t.div_(num_microbatches)
            loss = torch.stack(losses).mean()
        if mesh:
            grads = tree_map(sm.sum_replicas, grads)
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        metrics = {"loss": loss.float(), "grad_norm": gnorm.float(),
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return step
