"""SSD scan in model layout, dispatched on the tensors' device.

``ssd_scan(x, dt, A, B, C, chunk=Q)`` with x: (Bt, S, H, P), dt: (Bt, S, H),
A: (H,), B/C: (Bt, S, N), or (Bt, S, G, N) in G groups (the layouts
``ssm_block`` produces):

* makes the operands contiguous (``ssm_block`` hands it views of one
  projection),
* on CUDA tensors launches the hand-written Hopper kernel (:mod:`.kernel`)
  or raises; on CPU tensors runs the plain PyTorch version (:mod:`.ref`).
  There is no fallback from one to the other.

The chunk length is Q = min(chunk, S) on both paths.  It is a
``torch.autograd.Function``, as the reference's op is a ``custom_vjp``: the
backward recomputes the scan through the plain version and differentiates
both outputs, y and the final state, with respect to x, dt, A, B, C and
``init_state`` (zeros when none is given, whose gradient then goes
nowhere).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import ssd_reference


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk):
        if x.device.type not in ("cuda", "cpu", "meta"):
            raise ValueError(f"ssd_scan runs on cuda, cpu or meta, not "
                             f"{x.device}")
        args = [t.contiguous() for t in (x, dt, A, B, C)]
        if init_state is not None:
            init_state = init_state.contiguous()
        if x.device.type == "cuda":
            y, state = kernel.ssd_scan_fwd(*args, chunk=chunk,
                                           init_state=init_state)
        else:   # cpu, or meta: a dry run's shapes, which launch nothing
            y, state = ssd_reference(*args, chunk=chunk,
                                     init_state=init_state)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in saved[:5]]
            init = saved[5]
            if init is not None:
                init = init.detach().requires_grad_()
                inputs.append(init)
            outs = ssd_reference(*inputs[:5], chunk=ctx.chunk,
                                 init_state=init)
            grads = torch.autograd.grad(outs, inputs, (gy, gstate))
        if init is None:
            grads = grads + (None,)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, A and init_state fp32; B/C in x's dtype.  Returns (y (Bt, S, H,
    P) in x's dtype, final_state (Bt, H, P, N) fp32), both differentiable."""
    return _SSDScan.apply(x, dt, A, B, C, init_state, chunk)
