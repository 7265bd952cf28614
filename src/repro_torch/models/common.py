"""Shared model plumbing: the execution environment and the initializers.

Models are plain functions over nested dicts of tensors.  ``Env`` carries
where and in what precision they run; which attention runs is decided by the
tensors' device (the CUDA kernel on the card, its plain version on the CPU),
so there is no kernel switch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Union

import torch

Params = Dict[str, Any]
DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA (explicitly or by default) on a machine
    without it raises rather than running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Env:
    """Execution context threaded through model code."""

    device: torch.device
    compute_dtype: torch.dtype = torch.bfloat16


def default_env(device: DeviceLike = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> Env:
    return Env(resolve_device(device), compute_dtype)


# ---------------------------------------------------------------------------
# Initializers (explicit generator; weights in nn.Linear's (out, in) layout).
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], *,
               device: torch.device, dtype: torch.dtype = torch.float32,
               in_axis: int = -1) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in)), as the reference's
    ``dense_init``; drawn in fp32, then cast."""
    fan_in = shape[in_axis]
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
    return (t * fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], *,
               device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (t * 0.02).to(dtype)

