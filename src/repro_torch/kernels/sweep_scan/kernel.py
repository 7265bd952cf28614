"""Binds and launches the Hopper sweep-engine kernel.

``csrc/sweep_scan.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point at first use and loaded with
``ctypes`` (:mod:`repro_torch.kernels.nvcc`).  Nothing is built or imported
from CUDA when this module is imported.

The kernel runs one warp per (candidate, rate column) with its whole state
private to it, its rows as a wavefront: row r runs skew * lag ticks behind
the first row of its segment (``SweepStructure.row_lags``: a fleet batch's
DAGs each lag from their own first row), so it needs every in-edge to come
from an earlier row of the same segment (:func:`check_row_order`).
:func:`launch_shape` sizes a launch: the skew (sample_every, so that every
row samples in the same waves, or 1 where its deeper rings do not fit), up
to :data:`MAX_WARPS` warps a block, fewer where their state would not fit,
and the placement of that state: ``"shared"`` memory where one column fits
in the 227 KB a block can have, else ``"device"``, the same layout in a
device-memory scratch the wrapper allocates per block.  No size is
refused.  :func:`slot_index` lists each slot's real groups in group order,
the order of the busy scatter.

:func:`sweep_scan_fwd` takes the per-candidate placement (caps (C, G, K),
g_frac and g_slot (C, G), hops (C, E), counts (C, T)), the shared source
rates (T, K) and the packed structure (:class:`~.ref.SweepStructure`, on
the same device), allocates the outputs on the device, and launches the
whole sweep once on PyTorch's current stream.  Every launch is counted.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional, Tuple

import torch

from ..nvcc import build_library, check_operand
from .ref import SweepOutputs, SweepStructure, check_sweep_shapes, live_groups

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "sweep_scan.cu"
_ARGTYPES = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 17
             + [ctypes.c_longlong, ctypes.c_double, ctypes.c_int,
                ctypes.c_void_p])
#: where a launch keeps its columns' state: 0 shared memory, 1 device memory
PLACEMENTS = ("shared", "device")
#: warps (rate columns) a block runs at most
MAX_WARPS = 4
#: dynamic shared memory a block can have on an H100 (227 KB)
MAX_SHARED_BYTES = 232448

_LOCK = threading.Lock()
#: the loaded library and its build record, filled on first use
_LIB: Dict[str, object] = {}
_launches = 0


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library; returns the build
    record (``path``, compile ``seconds``, ``ptxas`` report)."""
    with _LOCK:
        if "lib" not in _LIB:
            _LIB.update(build_library(CSRC, "repro_sweep_scan", _ARGTYPES))
        return _LIB


def built() -> int:
    """1 once the library is built and loaded in this process, else 0."""
    with _LOCK:
        return int("lib" in _LIB)


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    with _LOCK:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _LOCK:
        _launches = 0


def ring_depth(n: int) -> int:
    """Depth of a ring of n entries: the least power of two >= n."""
    return 1 << max(n - 1, 0).bit_length()


def shared_bytes(G: int, S: int, T: int, E: int, n_out: int, n_sink: int,
                 L: int, skew: int, warps: int,
                 lag_rows: Optional[int] = None) -> int:
    """Bytes of a block's layout of ``warps`` warps, as
    ``sweep_scan.cu::shared_bytes`` lays it out: a 16-byte descriptor per
    row and per in-edge, g_frac and hops staged once; per warp queue,
    served, cap, its reciprocal, cap dt (G each), src_rate (T), busy (S),
    the realized ring (T rows) and the busy-term ring (L rows, L the most
    real groups of a candidate), both ``ring_depth(skew * (TL - 1) + 1)``
    deep, and the latency ring (T rows, ``ring_depth(TL)`` deep), all
    float64; then the int32 slot offsets, each group's place in slot order,
    the sink lists and each row's lag.  TL is ``lag_rows``, the longest
    segment's rows (None: T, one segment)."""
    TL = T if lag_rows is None else lag_rows
    d_rate, d_best = ring_depth(skew * (TL - 1) + 1), ring_depth(TL)
    per_warp = 5 * G + T + S + (T + L) * d_rate + T * d_best
    ints = S + 1 + G + 2 * n_out + 1 + n_sink + T
    return 16 * (T + E) + 8 * (G + E) + 8 * warps * per_warp + 4 * ints


def launch_shape(G: int, S: int, T: int, E: int, n_out: int, n_sink: int,
                 L: int, K: int, sample_every: int,
                 lag_rows: Optional[int] = None) -> Tuple[int, int, int, str]:
    """(warps per block, skew, bytes of a block's layout, placement) of a
    launch.  In ``"shared"`` memory where one column's state fits the
    block: the skew sample_every where its rings fit, else 1; then up to
    :data:`MAX_WARPS` warps, and no more than K, fewer where their state
    does not fit.  Where it does not fit even at skew 1, in ``"device"``
    memory at skew sample_every and min(MAX_WARPS, K) warps."""
    skews = tuple(dict.fromkeys((max(sample_every, 1), 1)))
    for skew in skews:
        for warps in range(min(MAX_WARPS, K), 0, -1):
            nbytes = shared_bytes(G, S, T, E, n_out, n_sink, L, skew, warps,
                                  lag_rows)
            if nbytes <= MAX_SHARED_BYTES:
                return warps, skew, nbytes, "shared"
    warps = min(MAX_WARPS, K)
    return (warps, skews[0], shared_bytes(G, S, T, E, n_out, n_sink, L,
                                          skews[0], warps, lag_rows),
            "device")


def check_row_order(structure: SweepStructure) -> None:
    """Raise ValueError unless every in-edge comes from an earlier row of
    the same segment: the kernel runs row r skew * lag ticks behind its
    segment's first row and reads its sources' realized rates of the same
    tick, which only earlier rows of the segment have made."""
    lags = structure.row_lags
    for row, edges in enumerate(structure.in_edges):
        late = [src for src, _ in edges if src >= row]
        if late:
            raise ValueError(
                f"row {row} has in-edges from rows {late}: the sweep kernel "
                "needs the rows in topological order")
        outside = [src for src, _ in edges if row - src > lags[row]]
        if outside:
            raise ValueError(
                f"row {row} has in-edges from rows {outside} before its "
                "segment's first row")


def slot_index(g_slot: torch.Tensor, live: torch.Tensor, n_slots: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each candidate's real groups by slot: (slot_off (C, S + 1),
    slot_grp (C, G)), int32.  Slot s's groups are
    ``slot_grp[c, slot_off[c, s]:slot_off[c, s + 1]]`` in ascending group
    order (a stable sort of g_slot); groups that are not ``live`` sort past
    the last slot."""
    key = torch.where(live, g_slot.long(), n_slots)
    slot_grp = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    per_slot = torch.zeros((key.shape[0], n_slots + 1), dtype=torch.int64,
                           device=key.device).scatter_add_(
                               1, key, torch.ones_like(key))
    slot_off = torch.zeros_like(per_slot)
    slot_off[:, 1:] = per_slot[:, :n_slots].cumsum(1)
    return slot_off.to(torch.int32), slot_grp.contiguous()


def sweep_scan_fwd(caps: torch.Tensor, src_rate: torch.Tensor,
                   g_frac: torch.Tensor, g_slot: torch.Tensor,
                   hops: torch.Tensor, counts: torch.Tensor,
                   structure: SweepStructure, *, steps: int,
                   sample_every: int, s0: int, dt: float) -> SweepOutputs:
    """The sweep of C candidates on one CUDA device, in float64.

    caps (C, G, K), src_rate (T, K), g_frac (C, G) and hops (C, E) float64;
    g_slot (C, G) and counts (C, T) int32; all contiguous and on the
    structure's device.  Returns (queues, busy, served, realized, lat) as
    in :func:`~.ref.sweep_scan_reference`, launched on the current
    stream."""
    if caps.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {caps.device}")
    C, T, G, S, n_out, K, n_samples = check_sweep_shapes(
        caps, src_rate, g_frac, g_slot, hops, counts, structure, steps,
        sample_every, s0)
    check_row_order(structure)
    E, n_sink = structure.n_edges, int(structure.sink_rows.numel())
    L = int(counts.sum(dim=1).max())      # the most real groups of a candidate
    warps, skew, nbytes, where = launch_shape(
        G, S, T, E, n_out, n_sink, L, K, sample_every, structure.lag_rows)
    dev = caps.device
    for name, t in (("caps", caps), ("src_rate", src_rate),
                    ("g_frac", g_frac), ("hops", hops),
                    ("edge_mult", structure.edge_mult)):
        check_operand(name, t, torch.float64, dev, align=8)
    for name, t in (("g_slot", g_slot), ("counts", counts),
                    ("row_off", structure.row_off),
                    ("row_lag", structure.row_lag),
                    ("edge_off", structure.edge_off),
                    ("edge_src", structure.edge_src),
                    ("sink_off", structure.sink_off),
                    ("sink_rows", structure.sink_rows)):
        check_operand(name, t, torch.int32, dev, align=4)
    slot_off, slot_grp = slot_index(g_slot, live_groups(structure, counts), S)
    f64 = dict(dtype=torch.float64, device=dev)
    out = SweepOutputs(                   # the kernel writes every element
        queues=torch.empty((C, G, K), **f64),
        busy=torch.empty((C, S, K), **f64),
        served=torch.empty((C, G, K), **f64),
        realized=torch.empty((C, T, K), **f64),
        latency=torch.empty((C, n_samples, n_out, K), **f64))
    scratch = None
    if where == "device":                # one 16-byte aligned stride a block
        stride = -(-nbytes // 16) * 16
        scratch = torch.empty(C * -(-K // warps) * stride, dtype=torch.uint8,
                              device=dev)
    fn = build()["fn"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(caps.data_ptr(), src_rate.data_ptr(), g_frac.data_ptr(),
             hops.data_ptr(), counts.data_ptr(), slot_off.data_ptr(),
             slot_grp.data_ptr(), structure.row_off.data_ptr(),
             structure.row_lag.data_ptr(),
             structure.edge_off.data_ptr(), structure.edge_src.data_ptr(),
             structure.edge_mult.data_ptr(), structure.sink_off.data_ptr(),
             structure.sink_rows.data_ptr(), out.queues.data_ptr(),
             out.busy.data_ptr(), out.served.data_ptr(),
             out.realized.data_ptr(), out.latency.data_ptr(),
             scratch.data_ptr() if scratch is not None else None, C, T, G, S,
             E, n_out, n_sink, L, K, n_samples, steps, sample_every, s0, skew,
             structure.lag_rows, warps, PLACEMENTS.index(where), nbytes,
             float(dt), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"sweep_scan launch failed: cudaError_t {err}")
    global _launches
    with _LOCK:
        _launches += 1
    return out
