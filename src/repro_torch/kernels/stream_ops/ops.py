"""The stream-operator bodies, dispatched on the tensors' device.

* On CUDA tensors each launches its hand-written Hopper kernel
  (:mod:`.kernel`) or raises;
* on CPU tensors each runs its plain PyTorch version (:mod:`.ref`).

There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernel
from .ref import (PI_ITERATIONS, SERVICE_WORK, external_service_reference,
                  parse_xml_reference, rolling_digest_reference,
                  viete_pi_reference)


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def parse_xml(payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tags, checksum), each (B,) int32, of a (B, L) uint8 payload."""
    if _on_cuda(payload, "parse_xml"):
        return kernel.parse_xml_fwd(payload)
    return parse_xml_reference(payload)


def viete_pi(value: torch.Tensor, iterations: int = PI_ITERATIONS
             ) -> torch.Tensor:
    """(B,) float32 Viète pi, one per tuple of ``value``."""
    if _on_cuda(value, "viete_pi"):
        return kernel.viete_pi_fwd(value, iterations)
    return viete_pi_reference(value.shape[0], value.device, iterations)


def rolling_digest(x: torch.Tensor) -> torch.Tensor:
    """(B,) float32 running digest of a (B,) float32 or int32 column."""
    if _on_cuda(x, "rolling_digest"):
        return kernel.rolling_digest_fwd(x)
    return rolling_digest_reference(x)


def external_service(v: torch.Tensor, work: int = SERVICE_WORK
                     ) -> torch.Tensor:
    """(B,) float32 external-service result for a (B,) float32 column."""
    if _on_cuda(v, "external_service"):
        return kernel.external_service_fwd(v, work)
    return external_service_reference(v, work)
