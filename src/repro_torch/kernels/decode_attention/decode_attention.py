"""K8, single-token GQA attention over a KV cache in float32, as a CUDA
kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py::
decode_attention_kernel``, whose sequential cache-block grid axis
carries the online softmax of a KV head's query group in VMEM. On
Hopper one block owns a (row, KV head), one warp per query head of the
group, and streams the row's cache through shared memory in
32-position tiles, so the group shares every K/V read. Two masks: the
first ``lengths[b]`` positions (the dense LM), or the reference's slot
mask ``0 <= slot_pos <= pos`` within ``window`` (the hybrid's ring
cache). Float32 throughout. Bound: memory, the cache read.
"""
from __future__ import annotations

import math

import torch

from .. import _build

MAX_HEAD_DIM = 128
MAX_GROUP = 32  # one warp per query head of a KV head's group


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            lengths: torch.Tensor | None = None, *,
                            slot_pos: torch.Tensor | None = None,
                            pos: torch.Tensor | None = None,
                            window: int = 0) -> torch.Tensor:
    """q: (B, H, d), k/v: (B, K, T, d) float32 CUDA tensors with unit
    stride on d (the model passes permuted views of its (B, T, K, d)
    cache), and either ``lengths`` (B,) int32 — positions t < lengths[b]
    are live — or ``slot_pos`` (B, T) and ``pos`` (B,) int32 with
    ``window`` >= 0 — slot t is live iff 0 <= slot_pos[b,t] <= pos[b]
    and, for window > 0, pos[b] - slot_pos[b,t] < window. Returns
    (B, H, d). Raises for a tensor off the card: there is no
    fallback."""
    _build.check_cuda(q, "q", torch.float32, 3, contiguous=False)
    for t, name in ((k, "k"), (v, "v")):
        _build.check_cuda(t, name, torch.float32, 4, contiguous=False)
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    if (lengths is None) == (slot_pos is None) or \
            (slot_pos is None) != (pos is None):
        raise ValueError("pass either lengths or slot_pos with pos")
    if lengths is not None:
        _build.check_cuda(lengths, "lengths", torch.int32, 1)
        if lengths.shape != (B,):
            raise ValueError(f"lengths {tuple(lengths.shape)} must be "
                             f"({B},)")
    else:
        _build.check_cuda(slot_pos, "slot_pos", torch.int32, 2)
        _build.check_cuda(pos, "pos", torch.int32, 1)
        if slot_pos.shape != (B, T) or pos.shape != (B,):
            raise ValueError(f"slot_pos {tuple(slot_pos.shape)} and pos "
                             f"{tuple(pos.shape)} must be ({B}, {T}) and "
                             f"({B},)")
        if window < 0:
            raise ValueError(f"window {window} must be >= 0 (0 = none)")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, K, T, d) for q {tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV "
                         f"heads")
    if H // K > MAX_GROUP:
        raise ValueError(f"group {H // K} exceeds {MAX_GROUP} query heads "
                         f"per KV head")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside [1, {MAX_HEAD_DIM}]")
    if T == 0:
        raise ValueError("decode_attention: empty cache")
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    _build.call("repro_decode_attention", q.device, _build.ptr(q),
                _build.ptr(k), _build.ptr(v), _build.opt_ptr(lengths),
                _build.opt_ptr(slot_pos), _build.opt_ptr(pos), int(window),
                _build.ptr(out), B, H, K, T, d, *q.stride()[:2],
                *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
                1.0 / math.sqrt(d), _build.stream(q))
    _build.count_launch("decode_attention", (B, H, K, T, d))
    return out
