"""Public SSD forward: the K9 intra-chunk step (``impl="kernel"``, on
the card) or its plain version (``"ref"``), then the inter-chunk
recurrence and the off-diagonal output in plain torch, which the
reference also keeps outside its Pallas kernel
(``src/repro/kernels/ssd/ops.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..util import resolve_impl
from .ref import ssd_chunk_ref
from .ssd import ssd_chunk_kernel


def ssd(x, dt, A, B, C, chunk: int = 128, impl: str = "auto"):
    """Full SSD forward. x: (b,s,h,p), dt: (b,s,h) post-softplus, A: (h,)
    negative, B/C: (b,s,n). s is padded to a multiple of ``chunk`` with
    dt = 0 steps (decay 1, no input: the state is untouched). Returns
    (y (b,s,h,p), final_state (b,h,p,n)) in x's dtype. ``impl``:
    "kernel" (K9; raises off the card) | "ref" | "auto" (the kernel for
    CUDA tensors, "ref" for CPU ones)."""
    impl = resolve_impl(impl, "ref", x)
    if impl not in ("kernel", "ref"):
        raise ValueError(f"ssd has no {impl!r} impl")
    b, s, h, p = x.shape
    pad = (-s) % chunk
    s_orig = s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s = s + pad
    step = ssd_chunk_kernel if impl == "kernel" else ssd_chunk_ref
    y_diag, states, chunk_decay, cum = step(
        x, dt.float().contiguous(), A.float().contiguous(), B, C,
        chunk=chunk)
    nc = s // chunk
    hprev = torch.zeros((b, h, p, states.shape[-1]), dtype=torch.float32,
                        device=x.device)
    prev = []
    for c in range(nc):
        prev.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)
    Cc = C.float().reshape(b, nc, chunk, -1)
    decay = torch.exp(cum.reshape(b, nc, chunk, h))
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * decay[..., None]
    y = y_diag + y_off.reshape(b, s, h, p)
    return y[:, :s_orig].to(x.dtype), hprev.to(x.dtype)
