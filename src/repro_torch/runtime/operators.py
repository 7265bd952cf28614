"""Representative stream operators (Table 1 analogues), each body one kernel.

Each operator consumes a micro-batch of tuples — a dict of tensors whose
leading axis is the tuple axis — and emits a micro-batch.  The reference
jits each body once per (task, slot) onto the device backing the slot;
here :func:`make_operator` binds the kind to that device, and each call
runs one hand-written CUDA kernel there
(:mod:`repro_torch.kernels.stream_ops`): on a CPU device, the kernel's
plain PyTorch version.  ``source`` and ``sink`` are identities and launch
nothing.

These mirror the profiler's single-tuple Python bodies
(:mod:`repro_torch.core.profiler`) but vectorized: the executor processes
tuples in micro-batches, which is also how a device-resident DSPS
amortizes dispatch.  ``checksum`` is int32 here (uint32 in the
reference).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..kernels.stream_ops import ops as stream_ops

Batch = Dict[str, torch.Tensor]


def _zeros(batch: Batch, n: int) -> torch.Tensor:
    """The reference's stand-in column when a batch lacks one."""
    device = next(iter(batch.values())).device if batch else None
    return torch.zeros(n, dtype=torch.float32, device=device)


def _op_parse_xml(batch: Batch) -> Batch:
    """Byte-level tag scan over a (B, L) uint8 payload (SAX-like single
    pass): counts open tags and extracts a checksum feature per tuple."""
    tags, checksum = stream_ops.parse_xml(batch["payload"])
    return {**batch, "tags": tags, "checksum": checksum}


def _op_pi(batch: Batch, iterations: int = 15) -> Batch:
    """Viete's product, vectorized over tuples (FP-heavy)."""
    return {**batch, "pi": stream_ops.viete_pi(batch["value"], iterations)}


def _op_batch_file_write(batch: Batch, window: int = 64) -> Batch:
    """Windowed accumulation: running digest over the micro-batch (the host
    flush is performed by the executor when the digest window rolls)."""
    v = batch.get("checksum", batch.get("value"))
    if v is None:
        v = _zeros(batch, 1)
    return {**batch, "digest": stream_ops.rolling_digest(v)}


def _op_external_service(batch: Batch, work: int = 64) -> Batch:
    """Azure Blob/Table stand-in: light on-device work; the service latency
    is injected by the executor (host-side wait), matching the profiler's
    ExternalService model."""
    v = batch.get("value")
    if v is None:
        v = _zeros(batch, batch["payload"].shape[0]
                   if "payload" in batch else 1)
    return {**batch, "service": stream_ops.external_service(
        v.to(torch.float32), work)}


OPERATORS: Dict[str, Callable[[Batch], Batch]] = {
    "parse_xml": _op_parse_xml,
    "pi": _op_pi,
    "batch_file_write": _op_batch_file_write,
    "azure_blob": _op_external_service,
    "azure_table": _op_external_service,
    "source": lambda b: b,
    "sink": lambda b: b,
}

#: host-side service latency (s) injected per micro-batch for external tasks
SERVICE_LATENCY = {"azure_blob": 0.010, "azure_table": 0.005}

#: operator kind -> the stream_ops kernel its body launches (source and
#: sink launch none)
KERNEL_OF = {"parse_xml": "parse_xml", "pi": "viete_pi",
             "batch_file_write": "rolling_digest",
             "azure_blob": "external_service",
             "azure_table": "external_service"}


class Operator:
    """One operator kind bound to the device of its slot: the port's
    counterpart of the reference's ``jax.jit(fn, device=dev)``.  A call
    moves its inputs to the device (a no-op for tensors already there) and
    runs the body."""

    def __init__(self, kind: str, device: torch.device):
        self.kind = kind
        self.device = torch.device(device)
        self.fn = OPERATORS[kind]

    def __call__(self, batch: Batch) -> Batch:
        return self.fn({k: v.to(self.device) for k, v in batch.items()})

    def __repr__(self) -> str:
        return f"Operator({self.kind!r}, {str(self.device)!r})"


def make_operator(kind: str, device) -> Operator:
    """Bind the operator body to ``device`` (the mapped slot's)."""
    return Operator(kind, device)
