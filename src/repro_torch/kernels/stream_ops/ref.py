"""Plain PyTorch versions of the four stream-operator kernels.

The bodies of the reference's runtime operators
(``repro/runtime/operators.py``), each over one routed part of a frame (B
tuples, B >= 1), computed as the reference rounds them:

* :func:`parse_xml_reference` — per tuple of a (B, L) uint8 payload, the
  open tags (a ``<`` whose next byte, taken cyclically so that the last
  byte's successor is byte 0, is not ``/``) and the byte sum;
* :func:`viete_pi_reference` — Viète's product from ``a = sqrt(2)`` over
  ``iterations - 1`` steps in float32, ``2 / prod`` for every tuple;
* :func:`rolling_digest_reference` — the running sum of a (B,) column in
  float32, left to right, each partial sum ``fmod`` 65521;
* :func:`external_service_reference` — the float32 sum of a (B,) column,
  then ``work`` steps of ``x = fmod(x * 1.000001 + 0.5, 1000)``, the
  result for every tuple.

The reference keeps ``checksum`` as uint32; here it is int32 (torch's
uint32 has few operations).  Its largest value, 126 x L per tuple, fits.
``fmod`` is exact, and JAX's ``%`` is ``fmod`` on these non-negative
operands.  The ``fori_loop`` steps of the reference and the running sum
are Python loops over float32 tensors, so every step rounds on its own
(``torch.cumsum`` on the CPU accumulates in float64).  These are the CPU
path of :mod:`.ops` and the oracle the CUDA kernels are held against.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: bytes the XML tag scan looks for
XML_OPEN, XML_SLASH = ord("<"), ord("/")
#: Adler's modulus, the rolling digest's
DIGEST_MODULUS = 65521.0
#: the external-service stand-in's chain: x = fmod(x * MUL + ADD, MOD)
SERVICE_MUL, SERVICE_ADD, SERVICE_MOD = 1.000001, 0.5, 1000.0
#: the reference operators' defaults (operators.py: _op_pi, _op_external_service)
PI_ITERATIONS, SERVICE_WORK = 15, 64


def parse_xml_reference(payload: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tags, checksum), each (B,) int32, of a (B, L) uint8 payload."""
    nxt = torch.roll(payload, -1, dims=-1)
    open_tag = (payload == XML_OPEN) & (nxt != XML_SLASH)
    tags = open_tag.sum(dim=-1, dtype=torch.int32)
    checksum = payload.sum(dim=-1, dtype=torch.int32)
    return tags, checksum


def viete_pi_reference(n: int, device: torch.device,
                       iterations: int = PI_ITERATIONS) -> torch.Tensor:
    """(n,) float32, Viète's approximation of pi, on ``device``."""
    a = torch.full((n,), 2.0, dtype=torch.float32, device=device).sqrt()
    prod = a / 2.0
    for _ in range(iterations - 1):
        a = torch.sqrt(2.0 + a)
        prod = prod * (a / 2.0)
    return 2.0 / prod


def rolling_digest_reference(x: torch.Tensor) -> torch.Tensor:
    """(B,) float32: the running float32 sum of ``x`` (float32 or int32),
    left to right, each partial sum ``fmod`` DIGEST_MODULUS."""
    v = x.to(torch.float32)
    acc = torch.zeros((), dtype=torch.float32, device=v.device)
    partial = []
    for i in range(v.shape[0]):
        acc = acc + v[i]
        partial.append(acc)
    return torch.fmod(torch.stack(partial), DIGEST_MODULUS)


def external_service_reference(v: torch.Tensor,
                               work: int = SERVICE_WORK) -> torch.Tensor:
    """(B,) float32: the chain from the float32 sum of ``v``, broadcast."""
    x = v.to(torch.float32).sum()
    for _ in range(work):
        x = torch.fmod(x * SERVICE_MUL + SERVICE_ADD, SERVICE_MOD)
    return x.expand(v.shape[0]).contiguous()
