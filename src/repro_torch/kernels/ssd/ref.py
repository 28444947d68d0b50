"""Plain PyTorch versions of K9, the Mamba-2 SSD intra-chunk step, and
the sequential oracle of the whole SSD scan (copies of the reference's
``_ssd_kernel`` arithmetic and of ``models/layers.py::ssd_reference``
in torch)."""
from __future__ import annotations

import torch


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int):
    """What K9 returns, in plain torch. x: (b, s, h, p), dt: (b, s, h)
    post-softplus, A: (h,) negative, B/C: (b, s, n), s % chunk == 0.
    Returns (y_diag (b,s,h,p), states (b,nc,h,p,n), chunk_decay
    (b,nc,h), cum (b,s,h)), all float32.

    Within chunk c, with cum the in-chunk prefix sum of dt·A:
    y_diag[i] = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j,
    states = sum_j exp(cum_last - cum_j) dt_j x_j ⊗ B_j and
    chunk_decay = exp(cum_last). exp(cum_i - cum_j) above the diagonal
    can overflow to inf, so it is selected away, never multiplied."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = x.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B.float().reshape(b, nc, chunk, n)
    Cc = C.float().reshape(b, nc, chunk, n)
    dA = dtc * A.float()
    cum = torch.cumsum(dA, dim=2)  # (b, nc, l, h)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [i, j]
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()
    L = torch.where(tri[:, :, None], torch.exp(diff),
                    torch.zeros((), device=x.device))
    xdt = xc * dtc[..., None]
    cb = Cc @ Bc.transpose(-1, -2)  # (b, nc, l, l)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * L, xdt)
    decay_state = torch.exp(cum[:, :, -1:, :] - cum)
    st = torch.einsum("bcln,bclhp->bchpn", Bc, decay_state[..., None] * xdt)
    dec = torch.exp(cum[:, :, -1, :])
    return (y.reshape(b, s, h, p), st, dec, cum.reshape(b, s, h))


def ssd_reference(x, dt, A, B, C):
    """Sequential oracle: h_t = h_{t-1}·exp(dt_t A) + dt_t B_t x_t;
    y_t = C_t h_t. x: (b,s,h,p), dt: (b,s,h), A: (h,), B/C: (b,s,n).
    Returns y (b,s,h,p)."""
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[-1]), dtype=x.dtype,
                        device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)  # (b, h)
        state = state * decay[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, dim=1)
