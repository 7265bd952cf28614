"""SSD scan in model layout, dispatched on the tensors' device.

``ssd_scan(x, dt, A, B, C, chunk=Q)`` with x: (Bt, S, H, P), dt: (Bt, S, H),
A: (H,), B/C: (Bt, S, N) (the layout ``ssm_block`` produces):

* makes the operands contiguous (``ssm_block`` hands it views of one
  projection),
* on CUDA tensors launches the hand-written Hopper kernel (:mod:`.kernel`)
  or raises; on CPU tensors runs the plain PyTorch version (:mod:`.ref`).
  There is no fallback from one to the other.

The chunk length is Q = min(chunk, S) on both paths.  Forward only: the
reference's ``custom_vjp`` backward (recompute through the plain version)
is training work and becomes a ``torch.autograd.Function`` in a later
slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import ssd_reference


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, A and init_state fp32; B/C in x's dtype.  Returns (y (Bt, S, H,
    P) in x's dtype, final_state (Bt, H, P, N) fp32)."""
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    if init_state is not None:
        init_state = init_state.contiguous()
    if x.device.type == "cuda":
        return kernel.ssd_scan_fwd(x, dt, A, B, C, chunk=chunk,
                                   init_state=init_state)
    if x.device.type == "cpu":
        return ssd_reference(x, dt, A, B, C, chunk=chunk,
                             init_state=init_state)
    raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
