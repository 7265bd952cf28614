"""Plain PyTorch chunked SSD (Mamba2) scan.

Semantics (Dao & Gu 2024, state-space duality):

    state_s = exp(dt_s * A) * state_{s-1} + dt_s * B_s (outer) x_s
    y_s     = C_s . state_s

computed chunk-wise as the reference's ``ssd_reference``: within a chunk
of Q tokens the recurrence unrolls into a masked attention-like product;
across chunks a (H, P, N) state is carried, here by a Python loop.  All
accumulation in fp32.

B and C are (Bt, S, N), one group shared by every head (the reference's
layout), or (Bt, S, G, N): G groups, head h reading group h // (H / G)
(Nemotron-H's Mamba2).  A single group given as (Bt, S, 1, N) takes the
one-group path.

The CPU path of :func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` and the
oracle the CUDA kernel is held against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bt,S,H,P)  dt: (Bt,S,H)  A: (H,) (negative)  B,C: (Bt,S,N) or
    (Bt,S,G,N).

    Returns (y: (Bt,S,H,P) in x's dtype, final_state: (Bt,H,P,N) fp32).
    """
    if B.ndim == 4 and B.shape[2] == 1:
        B, C = B[:, :, 0], C[:, :, 0]
    grouped = B.ndim == 4
    Bt, S, H, Pd = x.shape
    N = B.shape[-1]
    if grouped and H % B.shape[2]:
        raise ValueError(f"{H} heads do not divide into {B.shape[2]} groups")
    out_dtype = x.dtype
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:                                   # dt = 0: no-op steps
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0) * (B.ndim - 2) + (0, pad))
        C = F.pad(C, (0, 0) * (C.ndim - 2) + (0, pad))
    Sp = S + pad
    nc = Sp // Q

    xf = x.float().reshape(Bt, nc, Q, H, Pd)
    dtf = dt.float().reshape(Bt, nc, Q, H)
    Bf = B.float().reshape(Bt, nc, Q, *B.shape[2:])
    Cf = C.float().reshape(Bt, nc, Q, *C.shape[2:])
    Af = A.float()

    dA = dtf * Af[None, None, None, :]                     # (b,c,q,h) <= 0
    cum = torch.cumsum(dA, dim=2)                          # inclusive

    # ---- intra-chunk ------------------------------------------------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j, else 0         (b,c,i,j,h)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    # mask BEFORE exp: masked (i<j) positions have diff >> 0 whose exp()
    # overflows
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    if grouped:     # C_i . B_j once per group, then each head its group's
        Hg = H // B.shape[2]
        scores = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf) \
            .repeat_interleave(Hg, dim=4)                  # (b,c,i,j,h)
        Bf = Bf.repeat_interleave(Hg, dim=3)               # (b,c,q,h,n)
        Cf = Cf.repeat_interleave(Hg, dim=3)
    else:
        scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[:, :, :, :, None]
    att = scores * L * dtf[:, :, None, :, :]               # dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xf)

    # ---- chunk summaries ---------------------------------------------------
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtf           # (b,c,q,h)
    chunk_state = torch.einsum(
        "bcjh,bcjhn,bcjhp->bchpn" if grouped else "bcjh,bcjn,bcjhp->bchpn",
        w, Bf, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (b,c,h)

    # ---- inter-chunk scan ----------------------------------------------------
    state = (init_state.float() if init_state is not None
             else torch.zeros((Bt, H, Pd, N), dtype=torch.float32,
                              device=x.device))
    y_inter = []
    for c in range(nc):
        # y_inter_i = exp(cum_i) * (C_i . state)
        y_inter.append(torch.einsum(
            "bihn,bhpn->bihp" if grouped else "bin,bhpn->bihp", Cf[:, c],
            state) * torch.exp(cum[:, c])[:, :, :, None])
        state = chunk_decay[:, c, :, None, None] * state + chunk_state[:, c]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(Bt, Sp, H, Pd)[:, :S]
    return y.to(out_dtype), state
