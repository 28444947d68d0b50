"""Public flash attention over (B, H, S, d) tensors: K7 on the card,
the plain version on the CPU (``impl="auto"``). The reference's
``block_q``/``block_k`` padding knobs do not carry over: the kernel
masks its ragged tiles."""
from __future__ import annotations

import torch

from ..util import resolve_impl
from .flash_attention import flash_attention_kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """Attention of q (B, H, Sq, d) over k/v (B, K, Sk, d), H % K == 0;
    ``window`` > 0 keeps only keys less than ``window`` positions
    before the query (0: none). ``impl``: "kernel" (K7; raises off the card) | "ref" (plain torch) |
    "auto" (the kernel for CUDA tensors, "ref" for CPU ones)."""
    impl = resolve_impl(impl, "ref", q)
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    if impl == "kernel":
        return flash_attention_kernel(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention has no {impl!r} impl")
