"""The sweep engine, dispatched on the tensors' device.

``sweep_scan(caps, src_rate, g_frac, g_slot, hops, structure, steps=...,
sample_every=..., s0=..., dt=...)`` runs every tick of a rate sweep of C
candidate mappings (shapes in :mod:`.ref`):

* on CUDA tensors it launches the hand-written Hopper kernel
  (:mod:`.kernel`) or raises;
* on CPU tensors it runs the plain PyTorch version (:mod:`.ref`).

There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import SweepOutputs, SweepStructure, sweep_scan_reference


def sweep_scan(caps: torch.Tensor, src_rate: torch.Tensor,
               g_frac: torch.Tensor, g_slot: torch.Tensor, hops: torch.Tensor,
               structure: SweepStructure, *, steps: int, sample_every: int,
               s0: int, dt: float) -> SweepOutputs:
    """(queues, busy, served, realized, latency), each with a leading
    candidate axis, in float64 on the inputs' device."""
    args = (caps, src_rate, g_frac, g_slot, hops, structure)
    kw = dict(steps=steps, sample_every=sample_every, s0=s0, dt=dt)
    if caps.device.type == "cuda":
        return kernel.sweep_scan_fwd(*args, **kw)
    if caps.device.type == "cpu":
        return sweep_scan_reference(*args, **kw)
    raise ValueError(f"sweep_scan runs on cuda or cpu, not {caps.device}")
