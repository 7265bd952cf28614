"""Every collective of the port, issued and recorded in one place.

The counterpart of the reference's ``distributed/hloparse.py``.  The
reference reads its collectives out of the compiled HLO that GSPMD
produced; the port issues its collectives itself, so each wrapper below
records ``(op, bytes, group size)`` into the active :class:`CollectiveStats`
(:func:`recording`) as it issues the call.  The fields and the ring-algorithm
factors are the reference's:

    all-gather:        (g-1)/g * out_bytes
    reduce-scatter:    (g-1)/g * in_bytes
    all-reduce:        2*(g-1)/g * bytes
    all-to-all:        (g-1)/g * bytes
    collective-permute: bytes

``raw_bytes`` sums each call's per-rank result bytes, as the parser sums the
result shapes of the HLO ops.  The port produces no HLO, so the reference's
text parser (``parse_collectives``) has no input here and is not copied.

A wrapper issues its collective on a group of one too (NCCL runs on a
single card), where the ring factors give it 0 wire bytes.  A permute whose
source and destination are this rank moves nothing: it is a copy, recorded
with 0 wire bytes.  Nothing here catches a failed collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

_LOCK = threading.Lock()
#: the stats that the wrappers record into (``recording``), or None
_ACTIVE: List["CollectiveStats"] = []

_FACTOR = {
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    raw_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    wire_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_raw_bytes(self) -> int:
        return sum(self.raw_bytes.values())

    def summary(self) -> str:
        parts = [f"{k}: n={self.counts[k]} wire={self.wire_bytes[k]/1e6:.1f}MB"
                 for k in sorted(self.counts)]
        return "; ".join(parts) if parts else "none"

    def add(self, op: str, nbytes: int, group_size: int, *,
            moved: bool = True) -> None:
        """One collective of ``op`` whose per-rank result is ``nbytes``
        over a group of ``group_size``; ``moved=False`` (a permute onto
        this rank) puts no bytes on a wire."""
        factor = _FACTOR[op](group_size) if moved else 0.0
        self.counts[op] = self.counts.get(op, 0) + 1
        self.raw_bytes[op] = self.raw_bytes.get(op, 0) + int(nbytes)
        self.wire_bytes[op] = self.wire_bytes.get(op, 0.0) + nbytes * factor

    def as_dict(self) -> Dict[str, object]:
        return {"counts": dict(self.counts), "raw_bytes": dict(self.raw_bytes),
                "wire_bytes": dict(self.wire_bytes),
                "total_wire_bytes": self.total_wire_bytes,
                "total_raw_bytes": self.total_raw_bytes}


@contextlib.contextmanager
def recording(stats: Optional[CollectiveStats] = None
              ) -> Iterator[CollectiveStats]:
    """Record every collective issued inside the block into ``stats`` (a
    new one when None), which the block receives."""
    stats = CollectiveStats() if stats is None else stats
    with _LOCK:
        _ACTIVE.append(stats)
    try:
        yield stats
    finally:
        with _LOCK:
            _ACTIVE.remove(stats)


def _record(op: str, nbytes: int, group_size: int, moved: bool = True
            ) -> None:
    with _LOCK:
        for stats in _ACTIVE:
            stats.add(op, nbytes, group_size, moved=moved)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: the all-gather into one tensor (renamed in later torch releases)
_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``; returns ``t``."""
    dist.all_reduce(t, group=group)
    _record("all-reduce", _nbytes(t), group_size(group))
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    g = group_size(group)
    t = t.contiguous()
    out = t.new_empty((g * t.numel(),))
    _gather_flat(out, t.reshape(-1), group=group)
    out = out.reshape((g,) + tuple(t.shape))
    _record("all-gather", _nbytes(out), g)
    dim = dim % t.ndim
    return torch.cat(out.unbind(0), dim=dim) if g > 1 else out[0]


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (g, ...) split along dim 0: block j goes to group rank j;
    returns (g, ...) whose block j came from group rank j (the reference's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``)."""
    g = group_size(group)
    if t.shape[0] != g:
        raise ValueError(f"all_to_all needs a leading axis of {g}, got "
                         f"{tuple(t.shape)}")
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    _record("all-to-all", _nbytes(out), g)
    return out


def permute(t: torch.Tensor, *, send_to: int, recv_from: int,
            group) -> torch.Tensor:
    """The reference's ``ppermute`` for one rank: send ``t`` to global rank
    ``send_to`` and return what global rank ``recv_from`` sent (send/recv
    through ``batch_isend_irecv``).  Onto this very rank it is a copy."""
    g = group_size(group)
    me = dist.get_rank()
    if send_to == me and recv_from == me:
        _record("collective-permute", _nbytes(t), g, moved=False)
        return t.clone()
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, send_to, group=group),
           dist.P2POp(dist.irecv, out, recv_from, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _record("collective-permute", _nbytes(out), g)
    return out
