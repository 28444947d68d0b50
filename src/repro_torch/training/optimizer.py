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
card.

Over a model-parallel mesh (``Sharded`` leaves from
``models.params.shard_params``) the moments are laid out as
``state_specs`` says: like their parameter (the same positions, slices
and sharing), an int8 moment's block scales with their last axis
whole. ``global_norm`` counts each global element once and
``apply_updates`` updates each distinct part once. The int8 blocks are
the global tensor's: a part whose last axis is cut inside a 128-wide
block quantizes with that block's scale, the abs-max over every rank
that holds a piece of it, so the codes and scales are the one-device
ones.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..sharding import model as sm
from ..sharding.policy import PartitionSpec

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


def _nblocks(shape) -> int:
    return -(-shape[-1] // BLOCK) if len(shape) else 1


def abstract_state(abstract_params: dict, cfg: AdamWConfig) -> dict:
    """``init_state``'s shapes and dtypes as ``device="meta"`` tensors
    (the reference's ``ShapeDtypeStruct`` mirror): an int8 moment is
    ``q`` int8 shaped like the parameter and ``s`` float32 with one
    scale per 128-element block of the last axis."""
    dt = _moment_dtype(cfg)

    def zero_like(p):
        if cfg.moment_dtype == "int8":
            return {"q": torch.empty(p.shape, dtype=torch.int8,
                                     device="meta"),
                    "s": torch.empty((*p.shape[:-1], _nblocks(p.shape)),
                                     dtype=torch.float32, device="meta")}
        return torch.empty(p.shape, dtype=dt, device="meta")

    return {"m": tree_map(zero_like, abstract_params),
            "v": tree_map(zero_like, abstract_params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_specs(param_specs_tree: dict, cfg: AdamWConfig) -> dict:
    """``PartitionSpec``s of the optimizer state: each moment shards like
    its parameter; an int8 moment's ``q`` too, its ``s`` like it but
    for the last axis, which is replicated (the reference's rule)."""
    _moment_dtype(cfg)

    def spec_like(ps):
        if cfg.moment_dtype == "int8":
            s_spec = PartitionSpec(*ps[:-1], None) if len(ps) else ps
            return {"q": ps, "s": s_spec}
        return ps

    return {"m": tree_map(spec_like, param_specs_tree),
            "v": tree_map(spec_like, param_specs_tree),
            "step": PartitionSpec()}


def _zero_moment(p, cfg: AdamWConfig, dt):
    """A zero moment of parameter ``p``: on its device, or laid out as
    the ``Sharded`` ``p`` (``state_specs``)."""
    if isinstance(p, sm.Sharded):
        s_shape = (*p.shape[:-1], _nblocks(p.shape))
        if cfg.moment_dtype == "int8":
            return {"q": p.map(lambda t: torch.zeros(
                        t.shape, dtype=torch.int8, device=t.device),
                        torch.int8),
                    # quantize_i8 of zeros: every scale clamps to 1e-20
                    "s": sm.like(p, lambda idx, dev: torch.full(
                        sm.part_shape(s_shape, idx), 1e-20, device=dev),
                        torch.float32, s_shape[-1])}
        return p.map(lambda t: torch.zeros(t.shape, dtype=dt,
                                           device=t.device), dt)
    if cfg.moment_dtype == "int8":
        q, s = quantize_i8(torch.zeros(p.shape, device=p.device))
        return {"q": q, "s": s}
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def _home(p) -> torch.device:
    return p.parts[0, 0].device if isinstance(p, sm.Sharded) else p.device


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments beside every parameter, on its device (over a mesh
    laid out by ``state_specs``), and step 0 (on the mesh's first
    device)."""
    dt = _moment_dtype(cfg)
    device = _home(leaves(params)[0][1])
    return {"m": tree_map(lambda p: _zero_moment(p, cfg, dt), params),
            "v": tree_map(lambda p: _zero_moment(p, cfg, dt), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def shard_state(state: dict, params: dict) -> dict:
    """A state of global tensors (a checkpoint's) laid out beside the
    ``Sharded`` ``params``: each moment (an int8 moment's ``q`` and
    ``s``) as its parameter (``sharding.model.split_like``), the step
    on the mesh's first device."""
    def lay(m, p):
        if isinstance(m, dict) and set(m) == {"q", "s"}:
            return {k: sm.split_like(m[k], p) for k in ("q", "s")}
        if isinstance(m, dict):
            return {k: lay(m[k], p[k]) for k in m}
        return sm.split_like(m, p)

    return {"m": lay(state["m"], params), "v": lay(state["v"], params),
            "step": state["step"].to(_home(leaves(params)[0][1]))}


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


def _step(p, g, mf, vf, scale, b1c, b2c, cfg: AdamWConfig) -> None:
    """The moments ``mf``, ``vf`` (float32) and the parameter ``p``
    updated in place by the gradient ``g``."""
    g = g.float() * scale
    mf.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    vf.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    den = torch.div(vf, b2c, out=g).sqrt_().add_(cfg.eps)
    step = torch.div(mf, b1c).div_(den)  # the bias-corrected update
    p32 = p.float()
    step.add_(torch.mul(p32, cfg.weight_decay, out=den)).mul_(cfg.lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p32 - step)


def _update(p, g, m, v, scale, b1c, b2c, cfg: AdamWConfig) -> None:
    mf, vf = _read(m, cfg), _read(v, cfg)
    _step(p, g, mf, vf, scale, b1c, b2c, cfg)
    _write(m, mf, cfg)
    _write(v, vf, cfg)


# --------------------------------------------------------------------------
# the update over a model-parallel mesh
# --------------------------------------------------------------------------


def _blocks_of(idx, width: int, device) -> torch.Tensor:
    """The global 128-wide block of each of a part's ``width`` columns
    (its last-axis slice starts at ``idx[-1].start``)."""
    lo = idx[-1].start or 0
    return torch.div(torch.arange(lo, lo + width, device=device), BLOCK,
                     rounding_mode="floor")


def _read_i8_part(moment: dict, pos) -> torch.Tensor:
    """The float32 moment at position ``pos`` of a ``Sharded`` int8
    moment: its codes times its global blocks' scales (the products of
    ``dequantize_i8``)."""
    q, s = moment["q"].parts[pos], moment["s"].parts[pos]
    blocks = _blocks_of(moment["q"].index[pos], q.shape[-1], q.device)
    return q.float() * s.index_select(-1, blocks)


def _block_max(x: torch.Tensor, idx, nb: int) -> torch.Tensor:
    """(..., nb) abs-max of each global block over the columns of the
    part ``x`` at slices ``idx`` (0 where it holds none of a block)."""
    out = x.new_zeros((*x.shape[:-1], nb))
    if x.shape[-1]:
        lo = idx[-1].start or 0
        xb, _ = _blockify(F.pad(torch.abs(x), (lo % BLOCK, 0)))
        m = torch.amax(xb, dim=-1)
        out[..., lo // BLOCK:lo // BLOCK + m.shape[-1]] = m
    return out


def _write_i8_parts(moment: dict, vals: dict) -> None:
    """Quantize the float32 parts ``vals`` ({position: tensor}, one per
    distinct part) of a ``Sharded`` int8 moment in place, with the
    global blocks' scales: a block's abs-max is the max over every part
    that holds a piece of its row (a row: the slices of every axis but
    the last), on each scale part's device."""
    q, s = moment["q"], moment["s"]
    nb = s.shape[-1]
    rows: dict = {}
    for pos, x in vals.items():
        idx = q.index[pos]
        rows.setdefault(sm._key(idx[:-1]), []).append(
            _block_max(x, idx, nb))
    for pos, part in s.distinct():
        mx = functools.reduce(torch.maximum, [
            b.to(part.device) for b in rows[sm._key(s.index[pos][:-1])]])
        part.copy_(torch.clamp(mx / 127.0, min=1e-20))
    for pos, x in vals.items():
        scale = s.parts[pos].index_select(
            -1, _blocks_of(q.index[pos], x.shape[-1], x.device))
        q.parts[pos].copy_(torch.clamp(torch.round(x / scale), -127,
                                       127).to(torch.int8))


def _update_sharded(p: "sm.Sharded", g: "sm.Sharded", m, v, consts,
                    cfg: AdamWConfig) -> None:
    """One leaf's update over the mesh: each distinct part of ``p`` once,
    with the gradient and moment parts of its position (their sharing
    follows the parameter's); ``consts(device)`` gives (scale, b1c,
    b2c) there. int8 moments are read and quantized over the whole leaf
    (``_write_i8_parts``)."""
    if cfg.moment_dtype != "int8":
        for pos, part in p.distinct():
            _update(part, g.parts[pos], m.parts[pos], v.parts[pos],
                    *consts(part.device), cfg)
        return
    new_m, new_v = {}, {}
    for pos, part in p.distinct():
        mf, vf = _read_i8_part(m, pos), _read_i8_part(v, pos)
        _step(part, g.parts[pos], mf, vf, *consts(part.device), cfg)
        new_m[pos], new_v[pos] = mf, vf
    _write_i8_parts(m, new_m)
    _write_i8_parts(v, new_v)


@torch.no_grad()
def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the
    leaves in ``jax.tree.leaves`` order, as the reference's clip sums.
    A ``Sharded`` leaf counts each distinct global slice once (its
    first holder's piece of it; replicas hold equal gradients after
    ``sharding.model.sum_replicas``), its sums added on the first
    leaf's home device."""
    flat = leaves(grads)
    if not any(isinstance(g, sm.Sharded) for _, g in flat):
        total = 0
        for _, g in flat:
            total = total + torch.sum(torch.square(g.float()))
        return torch.sqrt(total)
    home = _home(flat[0][1])
    total = torch.zeros((), device=home)
    for _, g in flat:
        for idx, (first, *_) in g.slices():
            total = total + torch.sum(torch.square(
                g.piece(first, idx).float())).to(home)
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

    @functools.lru_cache(maxsize=None)
    def consts(device):
        return tuple(c.to(device) if isinstance(c, torch.Tensor) else c
                     for c in (scale, b1c, b2c))

    for (_, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if isinstance(p, sm.Sharded):
            _update_sharded(p, g, m, v, consts, cfg)
        else:
            _update(p, g, m, v, scale, b1c, b2c, cfg)
    state["step"] = step
    return params, state, gnorm
