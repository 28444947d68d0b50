"""Public flash attention over (B, H, S, d) tensors: K7 on the card,
the plain version on the CPU (``impl="auto"``), and the VLM's prefix-LM
mask as two K7 calls (``prefix_attention``). The reference's
``block_q``/``block_k`` padding knobs do not carry over: the kernel
masks its ragged tiles (the reference's wrapper pads the keys to its
block and, without ``causal``, leaves the padding unmasked; the port
does not copy that)."""
from __future__ import annotations

import torch

from ..util import resolve_impl
from .flash_attention import flash_attention_kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: str = "auto",
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of q (B, H, Sq, d) over k/v (B, K, Sk, d), H % K == 0;
    ``window`` > 0 keeps only keys less than ``window`` positions
    before the query (0: none). With ``out`` (q's shape) the result is
    written there and returned. ``impl``: "kernel" (K7; raises off the
    card) | "ref" (plain torch) | "auto" (the kernel for CUDA tensors,
    "ref" for CPU ones)."""
    impl = resolve_impl(impl, "ref", q)
    if impl == "ref":
        got = attention_ref(q, k, v, causal=causal, window=window)
        return got if out is None else out.copy_(got)
    if impl == "kernel":
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      out=out)
    raise ValueError(f"flash_attention has no {impl!r} impl")


def prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prefix: int, impl: str = "auto") -> torch.Tensor:
    """The prefix-LM mask (query i sees key j iff j <= i or j <
    ``prefix``) over q (B, H, S, d) and k/v (B, K, S, d) as two
    ``flash_attention`` calls: causal over all S rows, then the first
    ``prefix`` queries against the first ``prefix`` keys without the
    causal mask, written into those rows of the first call's output.
    Exact: a row i >= prefix sees every key before it, the prefix
    included, so its prefix mask is the causal one; a row i < prefix
    sees exactly the prefix's keys."""
    out = flash_attention(q, k, v, causal=True, impl=impl)
    if prefix > 0:
        p = min(prefix, q.shape[2])
        flash_attention(q[:, :, :p], k[:, :, :p], v[:, :, :p], causal=False,
                        impl=impl, out=out[:, :, :p])
    return out
