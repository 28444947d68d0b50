"""AdamW with optionally int8-quantised moments (blockwise, abs-max), the
reference's ``src/repro/training/optimizer.py`` on PyTorch.

The int8 path stores m and v as int8 with one float32 scale per
128-element block along the last axis, cutting optimizer memory 4x
against float32. Quantised leaves keep the parameter's shape.

The arithmetic is the reference's, in its order: the global-norm clip
sums the leaves in ``jax.tree.leaves`` order (sorted dict keys), the
moments update as ``m·b1 + (1 - b1)·g`` and ``v·b2 + (1 - b2)·g²`` with
every product and sum rounded apart (no fused multiply-add), then bias
correction and decoupled weight decay. ``torch.round`` rounds half to
even, as ``jnp.round`` does. The update runs in place under
``torch.no_grad()``: float32 moments and parameters are overwritten
with at most two leaf-sized temporaries, which is what lets a
2.8-billion-parameter model keep params, grads and both moments on one
card. ``abstract_state`` and ``state_specs`` wait for the
model-parallel mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

BLOCK = 128
MOMENT_DTYPES = ("fp32", "bf16", "int8")


@dataclass(frozen=True)
class AdamWConfig:
    """The optimizer's settings (the reference's fields and defaults)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "fp32"  # fp32 | bf16 | int8
    grad_clip: float = 1.0


# --------------------------------------------------------------------------
# blockwise int8 quantisation (shape-preserving)
# --------------------------------------------------------------------------


def _blockify(x: torch.Tensor):
    """(..., d) -> (..., nb, BLOCK) zero-padded."""
    d = x.shape[-1]
    nb = -(-d // BLOCK)
    pad = nb * BLOCK - d
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], nb, BLOCK), d


def quantize_i8(x: torch.Tensor):
    """(q int8 shaped like x, scale float32 (..., nb))."""
    xb, d = _blockify(x.float())
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    q = q.reshape(*q.shape[:-2], -1)[..., :d].contiguous()
    return q, scale[..., 0]


def dequantize_i8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The float32 tensor ``quantize_i8`` encoded as (q, scale)."""
    qb, d = _blockify(q.float())
    x = qb * scale[..., None]
    return x.reshape(*x.shape[:-2], -1)[..., :d]


# --------------------------------------------------------------------------


def leaves(tree: dict, prefix: str = "") -> list[tuple[str, object]]:
    """(dotted path, leaf) in ``jax.tree.leaves`` order: sorted keys,
    depth first. An int8 moment ({"q", "s"}) is one leaf."""
    if not isinstance(tree, dict) or set(tree) == {"q", "s"}:
        return [(prefix[:-1], tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves(tree[k], f"{prefix}{k}."))
    return out


def tree_map(fn, tree: dict) -> dict:
    """``fn`` of every leaf, in the nesting of ``tree``."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    if cfg.moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of {MOMENT_DTYPES}, "
                         f"got {cfg.moment_dtype!r}")
    return torch.bfloat16 if cfg.moment_dtype == "bf16" else torch.float32


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments beside every parameter, on its device, and step 0."""
    dt = _moment_dtype(cfg)

    def zero_like(p):
        if cfg.moment_dtype == "int8":
            q, s = quantize_i8(torch.zeros(p.shape, device=p.device))
            return {"q": q, "s": s}
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = leaves(params)[0][1].device
    return {"m": tree_map(zero_like, params),
            "v": tree_map(zero_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _read(moment, cfg: AdamWConfig) -> torch.Tensor:
    """The moment as float32: a float32 moment itself (updated in
    place), otherwise a new tensor."""
    if cfg.moment_dtype == "int8":
        return dequantize_i8(moment["q"], moment["s"])
    return moment.float()


def _write(moment, x: torch.Tensor, cfg: AdamWConfig) -> None:
    if cfg.moment_dtype == "int8":
        moment["q"], moment["s"] = quantize_i8(x)
    elif x is not moment:
        moment.copy_(x)


def _update(p, g, m, v, scale, b1c, b2c, cfg: AdamWConfig) -> None:
    g = g.float() * scale
    mf = _read(m, cfg)
    mf.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    vf = _read(v, cfg)
    vf.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    den = torch.div(vf, b2c, out=g).sqrt_().add_(cfg.eps)
    step = torch.div(mf, b1c).div_(den)  # the bias-corrected update
    p32 = p.float()
    step.add_(torch.mul(p32, cfg.weight_decay, out=den)).mul_(cfg.lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p32 - step)
    _write(m, mf, cfg)
    _write(v, vf, cfg)


@torch.no_grad()
def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the
    leaves in ``jax.tree.leaves`` order, as the reference's clip sums."""
    total = 0
    for _, g in leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig):
    """One AdamW step. ``params`` and ``state`` are updated in place and
    returned as (params, state, global grad norm), the reference's
    structure; ``grads`` (the tree of ``params``) is only read."""
    _moment_dtype(cfg)
    step = state["step"] + 1
    flat_g = [g for _, g in leaves(grads)]
    if cfg.grad_clip > 0:
        gnorm = global_norm(grads)
        scale = torch.clamp(
            cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    else:
        gnorm = torch.zeros((), device=step.device)
        scale = 1.0
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    flat_p = leaves(params)
    flat_m = [m for _, m in leaves(state["m"])]
    flat_v = [v for _, v in leaves(state["v"])]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in structure")
    for (_, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        _update(p, g, m, v, scale, b1c, b2c, cfg)
    state["step"] = step
    return params, state, gnorm
