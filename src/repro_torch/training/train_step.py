"""The train step: microbatched gradient accumulation, per-layer
remat and the AdamW update, the reference's
``src/repro/training/train_step.py`` on PyTorch.

``build_train_step(cfg, opt_cfg, num_microbatches, remat, accum_dtype)``
returns ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``. The reference's ``lax.scan`` over microbatches is a loop
(activation memory ∝ one microbatch); its donated buffers are the
in-place update of ``params`` and ``opt_state``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import forward_loss
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, apply_updates, leaves, tree_map


def _split_batch(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...) for every leaf."""
    def r(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"{n} microbatches")
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    return {k: r(v) for k, v in batch.items()}


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                   remat: Optional[str] = None):
    """(loss, grads) of ``forward_loss``, grads in the tree of
    ``params``. A leaf the loss does not reach (the SSM family's
    ``ln2``, which feeds nothing) gets zeros, as ``jax.grad`` gives."""
    flat = [p for _, p in leaves(params)]
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = forward_loss(cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    grad_of = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda p: grad_of[id(p)], params)


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     num_microbatches: int = 1,
                     remat: Optional[str] = "full",
                     accum_dtype: torch.dtype = torch.float32):
    """The step: the loss and gradients of each microbatch (the batch
    split as ``_split_batch`` splits it), gradients summed in
    ``accum_dtype`` and divided by the count, the mean loss, then
    ``apply_updates``. Metrics: ``loss``, ``grad_norm`` and the new
    ``step``."""
    def step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, grads = value_and_grad(cfg, params, batch, remat)
        else:
            mbs = _split_batch(batch, num_microbatches)
            grads, losses = None, []
            for i in range(num_microbatches):
                loss_i, g = value_and_grad(
                    cfg, params, {k: v[i] for k, v in mbs.items()}, remat)
                losses.append(loss_i)
                if grads is None:
                    grads = tree_map(lambda v: v.to(accum_dtype), g)
                else:
                    for (_, a), (_, b) in zip(leaves(grads), leaves(g)):
                        a.add_(b.to(accum_dtype))
                del g
            for _, a in leaves(grads):
                a.div_(num_microbatches)
            loss = torch.stack(losses).mean()
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        metrics = {"loss": loss.float(), "grad_norm": gnorm.float(),
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return step
