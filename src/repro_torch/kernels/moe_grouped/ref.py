"""Plain PyTorch version of the grouped relu^2 expert FFN.

The rows are the MoE's assignments sorted by expert: sorted row r is
token ``rows[r]`` sent to the expert whose range ``[offsets[e],
offsets[e + 1])`` holds r.  Each expert runs over its own rows only:

    h   = relu(x[rows] @ wu[e]) ** 2        rounded to x's dtype
    out[dest[r]] = scale[r] * (h @ wd[e])   in fp32

so the work follows the rows routed, not the experts times a capacity,
and no row is dropped.  Products accumulate in fp32, as the kernel's.

The CPU path of :func:`repro_torch.kernels.moe_grouped.ops.grouped_relu2`
and the oracle the CUDA kernels are held against on the card.  It reads
the offsets on the host, one expert at a time.
"""

from __future__ import annotations

import torch


def grouped_relu2(x: torch.Tensor, rows: torch.Tensor, dest: torch.Tensor,
                  scale: torch.Tensor, offsets: torch.Tensor,
                  wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """x (n, D); rows, dest, scale (n*k,); offsets (E + 1,); wu (E, D, F),
    wd (E, F, D) in x's dtype.  Returns (n*k, D) fp32."""
    out = torch.zeros((rows.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    if x.device.type == "meta":      # a dry run's shapes
        return out
    offs = offsets.tolist()
    for e in range(wu.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi == lo:
            continue
        u = x[rows[lo:hi]].float() @ wu[e].float()
        h = torch.relu(u).square().to(x.dtype)
        out[dest[lo:hi]] = (h.float() @ wd[e].float()) \
            * scale[lo:hi, None].float()
    return out
