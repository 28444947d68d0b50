"""Public single-token decode attention over a (B, K, T, d) cache: K8 on
the card, the plain version on the CPU (``impl="auto"``). The
reference's ``block_k`` padding knob does not carry over: the kernel
reads only each row's live prefix."""
from __future__ import annotations

import torch

from ..util import resolve_impl
from .decode_attention import decode_attention_kernel
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, impl: str = "auto"
                     ) -> torch.Tensor:
    """One query token per row, q (B, H, d), over the first
    ``lengths[b]`` positions of k/v (B, K, T, d). ``impl``: "kernel"
    (K8; raises off the card) | "ref" (plain torch) | "auto" (the kernel
    for CUDA tensors, "ref" for CPU ones)."""
    impl = resolve_impl(impl, "ref", q)
    if impl == "ref":
        return decode_attention_ref(q, k, v, lengths)
    if impl == "kernel":
        return decode_attention_kernel(q, k, v, lengths.to(torch.int32))
    raise ValueError(f"decode_attention has no {impl!r} impl")
