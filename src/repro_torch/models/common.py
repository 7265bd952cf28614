"""Shared model plumbing: the execution environment and the initializers.

Models are plain functions over nested dicts of tensors.  ``Env`` carries
where and in what precision they run, and whether the training forward
recomputes each layer in its backward; which attention runs is decided by
the tensors' device (the CUDA kernel on the card, its plain version on the
CPU), so there is no kernel switch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Sequence, Union

import torch
import torch.utils.checkpoint

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
    #: activation checkpointing of each layer body in the training forward,
    #: with the reference's default policy "nothing": the backward recomputes
    #: the whole body from its input
    remat: bool = True


def default_env(device: DeviceLike = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> Env:
    return Env(resolve_device(device), compute_dtype)


def layer_call(env: Env, body: Callable, *args):
    """``body(*args)``, checkpointed when ``env.remat``: only the layer's
    inputs are kept for the backward, which runs the body once more (the
    reference's ``jax.checkpoint`` with ``nothing_saveable``)."""
    if env.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False)
    return body(*args)


# ---------------------------------------------------------------------------
# Initializers (explicit generator; weights in nn.Linear's (out, in) layout).
# ---------------------------------------------------------------------------

#: the most elements drawn in fp32 at once (1 GiB): a larger tensor, such as
#: kimi-k2's (384, 7168, 2048) expert stack, is drawn slice by slice along
#: its first axis and cast slice by slice, so that initialising it never
#: holds the whole tensor in fp32
DRAW_LIMIT = 1 << 28


def _draw(shape: Sequence[int], draw, *, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    """``draw(t)`` fills an fp32 tensor in place; ``shape`` is filled from
    fp32 draws of at most :data:`DRAW_LIMIT` elements, cast to ``dtype``.
    A tensor within the limit is one draw, as ``draw`` on the whole."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_LIMIT // max(1, math.prod(shape[1:])))
    for start in range(0, shape[0], rows):
        t = torch.empty((min(rows, shape[0] - start),) + shape[1:],
                        dtype=torch.float32, device=device)
        out[start:start + t.shape[0]] = draw(t)
    return out


def dense_init(gen: torch.Generator, shape: Sequence[int], *,
               device: torch.device, dtype: torch.dtype = torch.float32,
               in_axis: int = -1) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in)), as the reference's
    ``dense_init``; drawn in fp32, then cast."""
    scale = shape[in_axis] ** -0.5

    def draw(t: torch.Tensor) -> torch.Tensor:
        torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
        return t * scale
    return _draw(shape, draw, device=device, dtype=dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], *,
               device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _draw(shape, lambda t: t.normal_(generator=gen) * 0.02,
                 device=device, dtype=dtype)
