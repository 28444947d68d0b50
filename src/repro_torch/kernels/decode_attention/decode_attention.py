"""K8, single-token GQA attention over a KV cache in float32, as a CUDA
kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py::
decode_attention_kernel``, whose sequential cache-block grid axis
carries the online softmax of a KV head's query group in VMEM. On
Hopper the cache is split (flash-decoding): one block per (row, KV
head, chunk of ``repro_decode_chunk()`` positions) copies only the
chunk's live K/V rows into shared memory, computes the group's scores
and P.V in float32 on CUDA cores and writes its partial softmax state
to a scratch; the last chunk of a (row, KV head) to arrive combines the
partials in chunk order and writes the output, all in one launch after
one memset of the arrival counters. Two masks: the first
``lengths[b]`` positions (the dense LM), or the reference's slot mask
``0 <= slot_pos <= pos`` within ``window`` (the hybrid's ring cache).
head_dim runs to 256 (paligemma-3b) in a second instance of the kernel,
whose combine keeps twice the registers; heads up to 128 keep the
narrow instance. Bound: bytes, the live cache rows.

The log-sum-exp route (``return_lse=True``) also returns each head's
log-sum-exp of its scaled scores, written where the output is
normalised, so that the attentions of the slices of one cache held by
several tensor-parallel ranks combine exactly
(``sharding/model.py::combine_partials``); a row with nothing live
then gives 0 and -inf.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from ..util import refuse_autograd

MAX_HEAD_DIM = 256
MAX_GROUP = 32  # query heads per KV head
MAX_ROW_HEADS = 65535  # rows x KV heads: the launch grid's second axis


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            lengths: torch.Tensor | None = None, *,
                            slot_pos: torch.Tensor | None = None,
                            pos: torch.Tensor | None = None,
                            window: int = 0, return_lse: bool = False):
    """q: (B, H, d), k/v: (B, K, T, d) float32 CUDA tensors with unit
    stride on d (the model passes permuted views of its (B, T, K, d)
    cache), and either ``lengths`` (B,) int32 — positions t < lengths[b]
    are live — or ``slot_pos`` (B, T) and ``pos`` (B,) int32 with
    ``window`` >= 0 — slot t is live iff 0 <= slot_pos[b,t] <= pos[b]
    and, for window > 0, pos[b] - slot_pos[b,t] < window. Returns
    (B, H, d), or with ``return_lse`` (out, lse): lse (B, H) float32
    the natural log of the sum of exp(scale · q·k) over the row's live
    slots, and a row with nothing live 0 and -inf (without it, the mean
    of V, as the plain version). Raises for a tensor off the card: there
    is no fallback. One memset and one kernel launch on the current
    stream."""
    refuse_autograd("decode_attention_kernel", q, k, v)
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
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0:
        return (out, lse) if return_lse else out
    if B * K > MAX_ROW_HEADS:
        raise ValueError(f"{B} rows x {K} KV heads exceed {MAX_ROW_HEADS}")
    lib = _build.library()
    scratch = torch.empty(lib.repro_decode_scratch_bytes(B, H, K, T, d),
                          dtype=torch.uint8, device=q.device)
    _build.call("repro_decode_attention", q.device, _build.ptr(q),
                _build.ptr(k), _build.ptr(v), _build.opt_ptr(lengths),
                _build.opt_ptr(slot_pos), _build.opt_ptr(pos), int(window),
                _build.ptr(out), _build.opt_ptr(lse), B, H, K, T, d,
                *q.stride()[:2],
                *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
                1.0 / math.sqrt(d), _build.ptr(scratch), _build.stream(q))
    route = "lengths" if lengths is not None else "slot_mask"
    _build.count_launch("decode_attention", (B, H, K, T, d),
                        f"{route}_lse" if return_lse else route)
    return (out, lse) if return_lse else out
