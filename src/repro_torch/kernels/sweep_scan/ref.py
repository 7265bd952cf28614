"""Plain PyTorch sweep engine: the scheduler's fluid tick loop in float64.

The same function as the reference's ``lax.scan`` kernel
(``repro/core/simulator.py::_make_scan_kernel``) and its numpy engine
(``_sweep_numpy``), batched over a leading candidate axis C: vectorised
over (C, K), Python over ticks and task rows, the busy scatter an
``index_add_`` in group order.  The CPU path of
:func:`repro_torch.kernels.sweep_scan.ops.sweep_scan` and the oracle the
CUDA kernel is held against on the card.

The structure of a sweep (which groups belong to which task row, the
in-edges, the sink rows of each output) is packed once by
:func:`pack_structure` into a :class:`SweepStructure` on the device: CSR
index arrays for the kernel, and the same lists for this plain version.

Each candidate also names its real groups per row, ``counts`` (C, T): the
first ``counts[c, r]`` groups of row r's span are real, the rest are the
padding of a search's shape bucket; in a plain sweep every group is real
(:func:`full_counts`).  Groups past the count take no part: they read as
cap = frac = 0, which is what a search pads with, so skipping them is
exact.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch


class SweepOutputs(NamedTuple):
    """One sweep's raw state, each with a leading candidate axis C."""

    queues: torch.Tensor      # (C, G, K) final queue length per group
    busy: torch.Tensor        # (C, S, K) busy-seconds within the window
    served: torch.Tensor      # (C, G, K) tuples served within the window
    realized: torch.Tensor    # (C, T, K) final-tick realized output rates
    latency: torch.Tensor     # (C, n_samples, n_out, K)


@dataclasses.dataclass(frozen=True)
class SweepStructure:
    """The shape-like part of a sweep spec, packed on one device.

    ``row_off`` (T + 1): groups of row r are ``row_off[r]:row_off[r + 1]``;
    ``edge_off`` (T + 1) with ``edge_src``/``edge_mult`` (E): the in-edges
    of each row in order (edge e's hop latency is column e of ``hops``);
    ``sink_off`` (n_out + 1) with ``sink_rows``: the sink rows of each
    output; ``row_lags`` (and ``row_lag``, on the device): each row's index
    within its segment, a maximal run of rows that no later row's in-edge
    reaches back before (one DAG of a stacked fleet batch).  Index arrays
    are int32, multipliers float64."""

    row_slices: Tuple[Tuple[int, int], ...]
    in_edges: Tuple[Tuple[Tuple[int, float], ...], ...]
    sink_groups: Tuple[Tuple[int, ...], ...]
    row_lags: Tuple[int, ...]
    n_slots: int
    row_off: torch.Tensor
    edge_off: torch.Tensor
    edge_src: torch.Tensor
    edge_mult: torch.Tensor
    sink_off: torch.Tensor
    sink_rows: torch.Tensor
    g_task: torch.Tensor      # (G,) int64 owning row of each group
    row_lag: torch.Tensor     # (T,) int32 row_lags

    @property
    def n_rows(self) -> int:
        return len(self.row_slices)

    @property
    def n_groups(self) -> int:
        return self.row_slices[-1][1] if self.row_slices else 0

    @property
    def n_edges(self) -> int:
        return sum(len(e) for e in self.in_edges)

    @property
    def n_out(self) -> int:
        return len(self.sink_groups)

    @property
    def lag_rows(self) -> int:
        """Rows of the longest segment."""
        return max(self.row_lags) + 1


def pack_structure(row_slices: Sequence[Tuple[int, int]],
                   in_edges: Sequence[Sequence[Tuple[int, float]]],
                   sink_groups: Sequence[Sequence[int]], n_slots: int,
                   device: torch.device) -> SweepStructure:
    """Check and pack one spec structure on ``device``.  Row group spans
    must tile ``0..G`` in row order; edge sources and sink rows must name
    rows."""
    rows = tuple((int(lo), int(hi)) for lo, hi in row_slices)
    edges = tuple(tuple((int(s), float(m)) for s, m in e) for e in in_edges)
    sinks = tuple(tuple(int(r) for r in rs) for rs in sink_groups)
    T = len(rows)
    if T == 0 or len(edges) != T:
        raise ValueError(f"{T} row spans but {len(edges)} in-edge lists")
    at = 0
    for lo, hi in rows:
        if lo != at or hi < lo:
            raise ValueError(f"row group spans {rows} do not tile 0..G")
        at = hi
    if any(not 0 <= s < T for e in edges for s, _ in e) or \
            any(not 0 <= r < T for rs in sinks for r in rs):
        raise ValueError("an in-edge source or sink row is not a task row")
    if n_slots < 0:
        raise ValueError(f"n_slots must be >= 0, got {n_slots}")

    def offsets(lists) -> torch.Tensor:
        out = [0]
        for items in lists:
            out.append(out[-1] + len(items))
        return torch.tensor(out, dtype=torch.int32, device=device)

    g_task = [r for r, (lo, hi) in enumerate(rows) for _ in range(lo, hi)]
    lags = segment_lags(edges)
    return SweepStructure(
        row_slices=rows, in_edges=edges, sink_groups=sinks, row_lags=lags,
        n_slots=int(n_slots),
        row_off=torch.tensor([0] + [hi for _, hi in rows], dtype=torch.int32,
                             device=device),
        edge_off=offsets(edges),
        edge_src=torch.tensor([s for e in edges for s, _ in e],
                              dtype=torch.int32, device=device),
        edge_mult=torch.tensor([m for e in edges for _, m in e],
                               dtype=torch.float64, device=device),
        sink_off=offsets(sinks),
        sink_rows=torch.tensor([r for rs in sinks for r in rs],
                               dtype=torch.int32, device=device),
        g_task=torch.tensor(g_task, dtype=torch.int64, device=device),
        row_lag=torch.tensor(lags, dtype=torch.int32, device=device))


def segment_lags(in_edges: Sequence[Sequence[Tuple[int, float]]]
                 ) -> Tuple[int, ...]:
    """Each row's index within its segment.  A segment starts at row r when
    no in-edge of row r or a later row comes from a row before r: the rows
    from r on never read the rows before it, so the kernel may run them on
    a lag of their own.  A stacked batch's DAGs (whose in-edges stay inside
    their own rows) each start one; a connected DAG in topological order
    is one segment."""
    first = len(in_edges)      # the earliest source of rows r, r + 1, ...
    starts = []
    for r in reversed(range(len(in_edges))):
        first = min([first] + [s for s, _ in in_edges[r]])
        starts.append(first >= r)
    lags: list = []
    for start in reversed(starts):
        lags.append(0 if start else lags[-1] + 1)
    return tuple(lags)


def n_samples_of(steps: int, sample_every: int) -> int:
    """Latency samples of a sweep: ticks with step % sample_every == 0."""
    return -(-steps // sample_every) if steps > 0 else 0


def row_sizes(structure: SweepStructure) -> torch.Tensor:
    """(T,) int32 groups in each row's span."""
    return (structure.row_off[1:] - structure.row_off[:-1]).to(torch.int32)


def full_counts(structure: SweepStructure, n_candidates: int) -> torch.Tensor:
    """(C, T) int32 counts that make every group real: a plain sweep's."""
    return row_sizes(structure).expand(n_candidates, -1).contiguous()


def live_groups(structure: SweepStructure, counts: torch.Tensor
                ) -> torch.Tensor:
    """(C, G) bool: group g of row r is real for candidate c when it is
    among the first ``counts[c, r]`` groups of the row's span."""
    g_task = structure.g_task
    first = structure.row_off[:-1].long()[g_task]
    pos = torch.arange(structure.n_groups, device=g_task.device) - first
    return pos[None, :] < counts.long()[:, g_task]


def check_sweep_shapes(caps: torch.Tensor, src_rate: torch.Tensor,
                       g_frac: torch.Tensor, g_slot: torch.Tensor,
                       hops: torch.Tensor, counts: torch.Tensor,
                       structure: SweepStructure, steps: int,
                       sample_every: int, s0: int
                       ) -> Tuple[int, int, int, int, int, int, int]:
    """(C, T, G, S, n_out, K, n_samples) of a sweep; raises ValueError on
    shapes that disagree with each other or with the structure."""
    if caps.ndim != 3:
        raise ValueError(f"caps must be (C, G, K), got {tuple(caps.shape)}")
    C, G, K = caps.shape
    T, E, S = structure.n_rows, structure.n_edges, structure.n_slots
    if (G != structure.n_groups or src_rate.shape != (T, K)
            or g_frac.shape != (C, G) or g_slot.shape != (C, G)
            or hops.shape != (C, E) or counts.shape != (C, T)):
        raise ValueError(
            f"bad shapes caps{tuple(caps.shape)} src_rate"
            f"{tuple(src_rate.shape)} g_frac{tuple(g_frac.shape)} g_slot"
            f"{tuple(g_slot.shape)} hops{tuple(hops.shape)} counts"
            f"{tuple(counts.shape)} for T={T}, G={structure.n_groups}, "
            f"E={E}")
    if C < 1 or K < 1:
        raise ValueError(f"a sweep needs C >= 1 and K >= 1, got C={C}, K={K}")
    if steps < 0 or sample_every < 1 or s0 < 0:
        raise ValueError(f"steps={steps}, sample_every={sample_every}, "
                         f"s0={s0}: need steps >= 0, sample_every >= 1, "
                         "s0 >= 0")
    if G and bool(((g_slot < 0) | (g_slot >= S)).any()):
        raise ValueError(f"g_slot holds a slot outside 0..{S - 1}")
    if bool(((counts < 0) | (counts > row_sizes(structure))).any()):
        raise ValueError("counts must lie in 0..the row's group span")
    return (int(C), T, int(G), S, structure.n_out, int(K),
            n_samples_of(steps, sample_every))


def sweep_scan_reference(caps: torch.Tensor, src_rate: torch.Tensor,
                         g_frac: torch.Tensor, g_slot: torch.Tensor,
                         hops: torch.Tensor, counts: torch.Tensor,
                         structure: SweepStructure, *, steps: int,
                         sample_every: int, s0: int,
                         dt: float) -> SweepOutputs:
    """The sweep of C candidates, float64, in the numpy engine's order of
    operations.  Shapes as :func:`repro_torch.kernels.sweep_scan.kernel.
    sweep_scan_fwd`; groups past ``counts`` read as cap = frac = 0."""
    C, T, G, S, n_out, K, n_samples = check_sweep_shapes(
        caps, src_rate, g_frac, g_slot, hops, counts, structure, steps,
        sample_every, s0)
    live = live_groups(structure, counts)
    caps = torch.where(live[:, :, None], caps, 0.0)
    g_frac = torch.where(live, g_frac, 0.0)
    f64 = dict(dtype=torch.float64, device=caps.device)
    queues = torch.zeros((C, G, K), **f64)
    busy = torch.zeros((C * S, K), **f64)
    served_acc = torch.zeros((C, G, K), **f64)
    realized = torch.zeros((C, T, K), **f64)
    served = torch.zeros((C, G, K), **f64)
    lat = torch.zeros((C, n_samples, n_out, K), **f64)
    cap_pos = caps > 0
    safe_caps = torch.where(cap_pos, caps, 1.0)
    caps_dt = caps * dt
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds differently from numpy's division
    dt_div = torch.tensor(dt, **f64)
    frac = g_frac[:, :, None]
    # candidate c's slot s is row c * S + s of the flat busy.  On the CPU
    # each slot's adds arrive in group order, as np.add.at makes them; on
    # CUDA index_add_ scatters float64 by atomics in no fixed order, so
    # there the sums agree with the kernel's only to rounding
    slot_rows = (g_slot.long() + S * torch.arange(C, device=caps.device)[:, None]
                 ).reshape(-1)
    for step in range(steps):
        for row, (lo, hi) in enumerate(structure.row_slices):
            edges = structure.in_edges[row]
            if not edges:
                in_rate = src_rate[row].expand(C, K)
            else:
                in_rate = torch.zeros((C, K), **f64)
                for src, mult in edges:
                    in_rate = in_rate + realized[:, src] * mult
            if lo == hi:
                realized[:, row] = in_rate
                continue
            arr = in_rate[:, None, :] * frac[:, lo:hi]
            q_len = queues[:, lo:hi] + arr * dt
            srv = torch.minimum(q_len, caps_dt[:, lo:hi])
            queues[:, lo:hi] = q_len - srv
            served[:, lo:hi] = srv
            total = srv[:, 0]
            for j in range(1, hi - lo):
                total = total + srv[:, j]
            realized[:, row] = total / dt_div
        if step >= s0:
            busy.index_add_(0, slot_rows, torch.where(
                cap_pos, served / safe_caps, 0.0).reshape(C * G, K))
            served_acc += served
        if step % sample_every == 0:
            lat[:, step // sample_every] = _path_latency(
                structure, queues, frac, cap_pos, safe_caps, hops)
    return SweepOutputs(queues, busy.reshape(C, S, K), served_acc, realized,
                        lat)


def _path_latency(structure: SweepStructure, queues: torch.Tensor,
                  frac: torch.Tensor, cap_pos: torch.Tensor,
                  safe_caps: torch.Tensor, hops: torch.Tensor) -> torch.Tensor:
    """(C, n_out, K): per task the routed queue wait + service time, plus
    hop latency along the longest source -> sink path, max over sink
    rows."""
    C, _, K = queues.shape
    contrib = torch.where(cap_pos, frac * (queues + 1.0) / safe_caps, 0.0)
    per_task = torch.zeros((C, structure.n_rows, K), dtype=queues.dtype,
                           device=queues.device
                           ).index_add_(1, structure.g_task, contrib)
    best = []
    e = 0
    for row, edges in enumerate(structure.in_edges):
        if not edges:
            best.append(per_task[:, row])
            continue
        up = torch.full((C, K), float("-inf"), dtype=queues.dtype,
                        device=queues.device)
        for src, _ in edges:
            up = torch.maximum(up, best[src] + hops[:, e, None])
            e += 1
        best.append(per_task[:, row] + up)
    out = torch.zeros((C, structure.n_out, K), dtype=queues.dtype,
                      device=queues.device)
    for i, rows in enumerate(structure.sink_groups):
        if rows:
            m = best[rows[0]]
            for r in rows[1:]:
                m = torch.maximum(m, best[r])
            out[:, i] = m
    return out
