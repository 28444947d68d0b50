"""Public single-token decode attention over a (B, K, T, d) cache: K8 on
the card, the plain version on the CPU (``impl="auto"``). The
reference's ``block_k`` padding knob does not carry over: the kernel
masks what it reads."""
from __future__ import annotations

import torch

from ..util import resolve_impl
from .decode_attention import decode_attention_kernel
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor | None = None, *,
                     slot_pos: torch.Tensor | None = None,
                     pos: torch.Tensor | None = None, window: int = 0,
                     impl: str = "auto", return_lse: bool = False):
    """One query token per row, q (B, H, d), over k/v (B, K, T, d):
    either the first ``lengths[b]`` positions, or the slots the
    reference's mask keeps (``slot_pos`` (B, T), ``pos`` (B,),
    ``window``; see ``decode_attention_kernel``). ``impl``: "kernel"
    (K8; raises off the card) | "ref" (plain torch) | "auto" (the kernel
    for CUDA tensors, "ref" for CPU ones). ``return_lse``: also each
    head's log-sum-exp (B, H) float32, the route a sequence slice of a
    cache takes (a row with nothing live: 0 and -inf)."""
    impl = resolve_impl(impl, "ref", q)
    if impl == "ref":
        return decode_attention_ref(q, k, v, lengths, slot_pos=slot_pos,
                                    pos=pos, window=window,
                                    return_lse=return_lse)
    if impl == "kernel":
        if lengths is not None:
            lengths = lengths.to(torch.int32)
        else:
            slot_pos = slot_pos.to(torch.int32)
            pos = pos.to(torch.int32)
        return decode_attention_kernel(q, k, v, lengths, slot_pos=slot_pos,
                                       pos=pos, window=window,
                                       return_lse=return_lse)
    raise ValueError(f"decode_attention has no {impl!r} impl")
