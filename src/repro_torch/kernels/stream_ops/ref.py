"""Plain PyTorch versions of the four stream-operator kernels.

The bodies of the reference's runtime operators
(``repro/runtime/operators.py``), each over one routed part of a frame (B
tuples, B >= 1), computed bit for bit as the reference's jitted programs
compute them on JAX's CPU:

* :func:`parse_xml_reference` — per tuple of a (B, L) uint8 payload, the
  open tags (a ``<`` whose next byte, taken cyclically so that the last
  byte's successor is byte 0, is not ``/``) and the byte sum;
* :func:`viete_pi_reference` — Viète's product from ``a = sqrt(2)`` over
  ``iterations - 1`` steps in float32, ``2 / prod`` for every tuple;
* :func:`rolling_digest_reference` — the running float32 sum of a (B,)
  column in XLA's blocked order (:func:`xla_cumsum`), each partial sum
  ``%`` 65521 as JAX takes it (:func:`jax_mod`);
* :func:`external_service_reference` — the float32 sum of a (B,) column in
  XLA's order (:func:`xla_sum`), then ``work`` steps of
  ``x = (x * 1.000001 + 0.5) % 1000`` with the multiply-add rounded once
  (:func:`fma_f32`), the result for every tuple.

Where XLA on the CPU departs from a left-to-right float32 reading of the
reference's source, and how these versions follow it (read from the
compiled HLO of jax 0.9.0 and held against it in
``tests/test_torch_stream_exact.py``):

* ``x * 1.000001 + 0.5`` compiles to one fused multiply-add on a host
  with FMA: one rounding, not two;
* ``jnp.sum`` of more than 32 values becomes windows of 32 (the padding
  split evenly, the odd element high), each summed in order, then the
  window sums, recursively; 32 or fewer are summed left to right;
* ``jnp.cumsum`` of more than 16 values becomes tiles of 16, each scanned
  in order, plus the exclusive prefix of the tile totals, scanned the same
  way, recursively;
* JAX's ``%`` is ``fmod``, plus the modulus where the remainder is
  non-zero and its sign differs from the modulus's.

None of these orders depends on the host's vector width: the windows and
tiles are rewrites of the HLO, and XLA compiles without fast-math, so
LLVM keeps each loop's float32 adds in order.

The reference keeps ``checksum`` as uint32; here it is int32 (torch's
uint32 has few operations).  Its largest value, 255 x L for a row of L
bytes (any uint8 byte), fits for L <= 8,421,504.
These are the CPU path of :mod:`.ops` and the oracle the CUDA kernels are
held against, to 0.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

#: bytes the XML tag scan looks for
XML_OPEN, XML_SLASH = ord("<"), ord("/")
#: Adler's modulus, the rolling digest's
DIGEST_MODULUS = 65521.0
#: the external-service stand-in's chain: x = (x * MUL + ADD) % MOD
SERVICE_MUL, SERVICE_ADD, SERVICE_MOD = 1.000001, 0.5, 1000.0
#: SERVICE_MUL as the float32 constant the reference multiplies by: 1 + 2**-20
SERVICE_MUL_F32 = float(torch.tensor(SERVICE_MUL, dtype=torch.float32))
#: the reference operators' defaults (operators.py: _op_pi, _op_external_service)
PI_ITERATIONS, SERVICE_WORK = 15, 64
#: XLA's CPU pipeline: a sum's window and a scan's tile
SUM_WINDOW, SCAN_TILE = 32, 16


def jax_mod(r: torch.Tensor, modulus) -> torch.Tensor:
    """``r % modulus`` as JAX computes it for a positive ``modulus`` (a
    float or a 0-d tensor of ``r``'s dtype):
    ``fmod`` (exact), then ``+ modulus`` (rounded) where the remainder is
    negative."""
    r = torch.fmod(r, modulus)
    return torch.where(r < 0, r + modulus, r)


def fma_f32(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``x * mul + add`` rounded once, as a fused multiply-add.

    ``mul`` and ``add`` are float32 values held as 0-d float64 tensors on
    ``x``'s device.  The product of two float32 values is exact in
    float64.  The sum is taken in float64 and rounded to odd: its error is
    exact (Fast2Sum with ``add`` first, valid where ``|p| <= |add|``;
    elsewhere the float64 sum of these operands is exact and the error 0),
    and an inexact result with an even last bit moves one step toward the
    exact value.  Rounding that to float32 is the single rounding of the
    exact value, since float64 keeps more than 24 + 1 bits.  Infinities
    and NaNs come out as the fused operation gives them."""
    p = x.to(torch.float64) * mul
    s = p + add
    err = (add - s) + p                  # p + add == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, err * torch.inf)
    return torch.where((err != 0) & even, odd, s).to(torch.float32)


def xla_sum(v: torch.Tensor) -> torch.Tensor:
    """0-d float32: the sum of a (B,) float32 column in XLA's CPU order."""
    while v.shape[0] > SUM_WINDOW:
        n = v.shape[0]
        windows = -(-n // SUM_WINDOW)
        pad = windows * SUM_WINDOW - n
        w = F.pad(v, (pad // 2, pad - pad // 2)).view(windows, SUM_WINDOW)
        acc = torch.zeros(windows, dtype=torch.float32, device=v.device)
        for j in range(SUM_WINDOW):
            acc = acc + w[:, j]
        v = acc
    acc = torch.zeros((), dtype=torch.float32, device=v.device)
    for i in range(v.shape[0]):
        acc = acc + v[i]
    return acc


def xla_cumsum(v: torch.Tensor) -> torch.Tensor:
    """(B,) float32: the inclusive running sum of a (B,) float32 column in
    XLA's CPU order."""
    n = v.shape[0]
    if n <= SCAN_TILE:
        acc = torch.zeros((), dtype=torch.float32, device=v.device)
        out = []
        for i in range(n):
            acc = acc + v[i]
            out.append(acc)
        return torch.stack(out)
    tiles = -(-n // SCAN_TILE)
    t = F.pad(v, (0, tiles * SCAN_TILE - n)).view(tiles, SCAN_TILE)
    acc = torch.zeros(tiles, dtype=torch.float32, device=v.device)
    cols = []
    for j in range(SCAN_TILE):
        acc = acc + t[:, j]
        cols.append(acc)
    prefix = torch.stack(cols, dim=1)
    totals = xla_cumsum(prefix[:, -1].contiguous())
    offset = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (prefix + offset[:, None]).reshape(-1)[:n]


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
    """(B,) float32: the running float32 sum of ``x`` (float32 or int32) in
    XLA's order, each partial sum ``%`` DIGEST_MODULUS as JAX takes it."""
    return jax_mod(xla_cumsum(x.to(torch.float32)), DIGEST_MODULUS)


def external_service_reference(v: torch.Tensor,
                               work: int = SERVICE_WORK) -> torch.Tensor:
    """(B,) float32: the chain from the float32 sum of ``v``, broadcast."""
    x = xla_sum(v.to(torch.float32))
    mul, add = (torch.tensor(c, dtype=torch.float64, device=x.device)
                for c in (SERVICE_MUL_F32, SERVICE_ADD))
    mod = torch.tensor(SERVICE_MOD, dtype=torch.float32, device=x.device)
    for _ in range(work):
        x = jax_mod(fma_f32(x, mul, add), mod)
    return x.expand(v.shape[0]).contiguous()
