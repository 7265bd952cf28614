"""Weights drawn from the seed, on the device, in the type they are served
in, as one buffer filled by a few large calls.

A family's reference (``perfbench/reference/<family>.py``) lists its
leaves with ``weight_spec(sizes)``: ``(name, shape, kind)``, where kind is
``("fan_in", axis)`` (a normal scaled by the axis's size to the -1/2),
``("std", s)`` (a normal times ``s``), ``("gain", s)`` (a norm's gain,
applied as ``1 + w``: a normal times ``s``), or one of Mamba2's
``("a_log",)`` (``log A``, ``A`` uniform in [1, 16]), ``("dt_bias",)``
(the inverse softplus of a ``dt`` log-uniform in [1e-3, 0.1]) and
``("one_plus", s)`` (``1 +`` a normal times ``s``).  The uniform draws
are the normal's probabilities, so everything comes from one stream.
The same tensors go to the program (in its layout,
``perfbench/layouts/<family>.py``) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: elements a call of ``normal_`` fills
CHUNK = 1 << 28
#: each leaf starts on a 128-byte boundary
ALIGN = 64

Spec = List[Tuple[str, Tuple[int, ...], tuple]]


def generator_seed(seed: int) -> int:
    """A ``torch.Generator`` seed from any whole number."""
    return int(seed) % (1 << 63)


def _uniform(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def draw(spec: Spec, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    """Name -> tensor (a view of one buffer) for every leaf of ``spec``."""
    offsets, total = [], 0
    for _, shape, _ in spec:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed))
    for a in range(0, total, CHUNK):
        buf[a:a + CHUNK].normal_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, kind), at in zip(spec, offsets):
        w = buf[at:at + math.prod(shape)].view(shape)
        what = kind[0]
        if what == "fan_in":
            w.mul_(shape[kind[1]] ** -0.5)
        elif what in ("std", "gain"):
            w.mul_(kind[1])
        elif what == "one_plus":
            w.mul_(kind[1]).add_(1.0)
        elif what == "a_log":
            w.copy_(torch.log(1.0 + 15.0 * _uniform(w.float())))
        elif what == "dt_bias":
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = torch.exp(lo + _uniform(w.float()) * (hi - lo))
            w.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = w
    return out
