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
result shapes of the HLO ops (a reduce-scatter's wire bytes come from its
input, as the formula says).  The port produces no HLO, so the reference's
text parser (``parse_collectives``) has no input here and is not copied.

Training differentiates through collectives, which GSPMD gave the
reference for free.  The functions of the second half of this module are
``torch.autograd.Function`` pairs whose backward is the collective's
transpose, issued through the same wrappers, so :func:`recording` counts
the backward's collectives too.  Their convention is Megatron's: a tensor
replicated over the tp ranks carries the *whole* gradient of the rank's
loss on every one of them, and the batch axes sum their ranks' gradients.

    gather       all-gather        | reduce-scatter (the sum over the group)
    scatter_sum  reduce-scatter    | all-gather
    copy_to      identity          | all-reduce     (Megatron's f)
    reduce_from  all-reduce        | identity       (Megatron's g)
    gather_from  all-gather        | this rank's block
    split_to     this rank's block | all-gather
    exchange     all-to-all        | the inverse all-to-all

Without grad (serving) each of them is the plain wrapper, or nothing where
its forward is the identity or a slice, so serving issues the collectives
it issued before.

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
            moved: bool = True, wire_nbytes: Optional[int] = None) -> None:
        """One collective of ``op`` whose per-rank result is ``nbytes``
        over a group of ``group_size``; ``moved=False`` (a permute onto
        this rank) puts no bytes on a wire; ``wire_nbytes``: the bytes the
        ring factor applies to, where not the result's (a reduce-scatter's
        input)."""
        factor = _FACTOR[op](group_size) if moved else 0.0
        base = nbytes if wire_nbytes is None else wire_nbytes
        self.counts[op] = self.counts.get(op, 0) + 1
        self.raw_bytes[op] = self.raw_bytes.get(op, 0) + int(nbytes)
        self.wire_bytes[op] = self.wire_bytes.get(op, 0.0) + base * factor

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


def _record(op: str, nbytes: int, group_size: int, moved: bool = True,
            wire_nbytes: Optional[int] = None) -> None:
    with _LOCK:
        for stats in _ACTIVE:
            stats.add(op, nbytes, group_size, moved=moved,
                      wire_nbytes=wire_nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: the all-gather into one tensor (renamed in later torch releases)
_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
#: the reduce-scatter from one tensor (renamed likewise)
_scatter_flat = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place reduction (``op``: "sum" or "max") of ``t`` over ``group``;
    returns ``t``."""
    dist.all_reduce(t, op=_OPS[op], group=group)
    _record("all-reduce", _nbytes(t), group_size(group))
    return t


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of the ranks' ``t`` over ``group``, cut along ``dim`` into
    equal blocks in group-rank order: this rank's block."""
    g = group_size(group)
    dim = dim % t.ndim
    if t.shape[dim] % g:
        raise ValueError(f"dimension {t.shape[dim]} does not divide over "
                         f"{g} ranks")
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // g,) + tuple(x.shape[1:]))
    _scatter_flat(out, x, group=group)
    _record("reduce-scatter", _nbytes(out), g, wire_nbytes=_nbytes(x))
    return out.movedim(0, dim)


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


# ---------------------------------------------------------------------------
# Collectives that carry gradients
# ---------------------------------------------------------------------------

def _block_of(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` cut along ``dim`` over ``group``."""
    g = group_size(group)
    n = t.shape[dim] // g
    return t.narrow(dim, dist.get_rank(group) * n, n)


def _fresh(g: torch.Tensor) -> torch.Tensor:
    """A contiguous copy for an in-place collective on a gradient, which
    autograd may share with another consumer."""
    return g.clone(memory_format=torch.contiguous_format)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_fresh(g), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(_fresh(t), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block_of(g, ctx.group, ctx.dim).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block_of(t, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def _differentiated(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters the gradient
    (FSDP's weight gather, whose backward is also the batch axes' gradient
    sum; the sequence-parallel gather before a column-parallel input)."""
    if _differentiated(t):
        return _Gather.apply(t, group, dim)
    return all_gather(t, group, dim)


def scatter_sum(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Reduce-scatter along ``dim``; the backward all-gathers (the
    sequence-parallel form of a row-parallel output's all-reduce)."""
    if _differentiated(t):
        return _ScatterSum.apply(t, group, dim)
    return reduce_scatter(t, group, dim)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward all-reduces the gradient (Megatron's f: the
    input of a column-parallel region, or a replicated weight whose ranks
    compute different parts of its gradient)."""
    if _differentiated(t):
        return _CopyTo.apply(t, group)
    return t


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (in place without grad); the backward passes the
    gradient through (Megatron's g: a row-parallel output)."""
    if _differentiated(t):
        return _ReduceFrom.apply(t, group)
    return all_reduce(t, group)


def gather_from(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` into a tensor every rank then uses whole;
    the backward keeps this rank's block of the gradient."""
    if _differentiated(t):
        return _GatherFrom.apply(t, group, dim)
    return all_gather(t, group, dim)


def split_to(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of a replicated tensor; the
    backward all-gathers the blocks' gradients."""
    if _differentiated(t):
        return _SplitTo.apply(t, group, dim)
    return _block_of(t, group, dim)


def exchange(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all`; the backward is the same exchange, its own
    inverse."""
    if _differentiated(t):
        return _Exchange.apply(t, group)
    return all_to_all(t, group)
