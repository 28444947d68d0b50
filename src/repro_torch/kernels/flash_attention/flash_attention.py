"""K7, causal GQA flash attention forward in float32, as a CUDA kernel
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention_kernel``, whose sequential key-block grid axis carries
the online-softmax state in VMEM. On Hopper one block of four warps
owns a tile of 64 queries of one (row, head) and loops over 32-key
tiles in a two-stage shared-memory ring (two blocks per SM at d = 128),
filled by the TMA unit from tensor maps where every base and stride is
16-byte aligned (the model's views), by ``cp.async`` otherwise, in the
TMA unit's 128-byte swizzle. Q·Kᵀ and P·V run on the tensor cores in
error-compensated TF32: each float32 operand is split into two TF32
parts and a product is three ``mma.sync`` products
(``csrc/mma_tf32x3.cuh``), within a few float32 ulps where one TF32
product would be off by ~5e-4 relative. Scores, m, l and the output
stay in registers; whole future tiles are skipped under ``causal``, and
whole tiles before the first query's window under ``window``, ragged
ends are masked, the KV head is ``h // group`` and every operand is
addressed through its strides, the output too (``out=``: the VLM's
prefix route writes its image rows into the causal call's output).
head_dim runs to 256 (paligemma-3b), where the tiles take 194 KB of
shared memory, one block per SM. Bound: bytes at the model's widths.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from ..util import refuse_autograd

MAX_HEAD_DIM = 256


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, Sq, d), k/v: (B, K, Sk, d) float32 CUDA tensors with
    H % K == 0, d <= 256 and unit stride on d; other strides are free
    (the model passes transposed views of its (B, S, H, d)
    projections). ``causal`` keeps key j for query i where j <= i
    (Sq and Sk may differ: cross-attention runs ``causal=False``).
    ``window`` > 0 also masks keys ``window`` or more positions before
    the query (the hybrid's sliding window); 0 is none. Returns (B, H,
    Sq, d), laid out like ``q``, or written into ``out`` (a (B, H, Sq,
    d) float32 view on the card with unit stride on d, which must not
    overlap q, k or v) and returned. Raises for a tensor off the card:
    there is no fallback."""
    refuse_autograd("flash_attention_kernel", q, k, v)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_cuda(t, name, torch.float32, 4, contiguous=False)
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, K, Sk, d) for q {tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV "
                         f"heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside [1, {MAX_HEAD_DIM}]")
    if Sk == 0:
        raise ValueError("flash_attention: no keys")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0 (0 = none)")
    if out is None:
        out = torch.empty_like(q)  # keeps a dense view's strides
    else:
        _build.check_cuda(out, "out", torch.float32, 4, contiguous=False)
        if out.shape != q.shape or out.device != q.device:
            raise ValueError(f"out {tuple(out.shape)} must be q's shape "
                             f"{tuple(q.shape)} on its device")
    if out.numel() == 0:
        return out
    _build.call("repro_flash_attention", q.device, _build.ptr(q),
                _build.ptr(k), _build.ptr(v), _build.ptr(out), B, H, K, Sq,
                Sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], 1.0 / math.sqrt(d), int(causal),
                int(window), _build.stream(q))
    _build.count_launch("flash_attention", (B, H, K, Sq, Sk, d),
                        ("causal" if causal else "bidir")
                        + ("+window" if window else ""))
    return out
