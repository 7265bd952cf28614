"""Binds and launches the Hopper sweep-engine kernel.

``csrc/sweep_scan.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point at first use and loaded with
``ctypes`` (:mod:`repro_torch.kernels.nvcc`).  Nothing is built or imported
from CUDA when this module is imported.

:func:`sweep_scan_fwd` takes the per-candidate placement (caps (C, G, K),
g_frac and g_slot (C, G), hops (C, E)), the shared source rates (T, K) and
the packed structure (:class:`~.ref.SweepStructure`, on the same device),
allocates the zeroed outputs and the scratch on the device, and launches
the whole sweep once on PyTorch's current stream.  Every launch is counted.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict

import torch

from ..nvcc import build_library, check_operand
from .ref import SweepOutputs, SweepStructure, check_sweep_shapes

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "sweep_scan.cu"
_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
             + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])

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


def sweep_scan_fwd(caps: torch.Tensor, src_rate: torch.Tensor,
                   g_frac: torch.Tensor, g_slot: torch.Tensor,
                   hops: torch.Tensor, structure: SweepStructure, *,
                   steps: int, sample_every: int, s0: int,
                   dt: float) -> SweepOutputs:
    """The sweep of C candidates on one CUDA device, in float64.

    caps (C, G, K), src_rate (T, K), g_frac (C, G) and hops (C, E) float64;
    g_slot (C, G) int32; all contiguous and on the structure's device.
    Returns (queues, busy, served, realized, lat) as in
    :func:`~.ref.sweep_scan_reference`, launched on the current stream."""
    if caps.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {caps.device}")
    C, T, G, S, n_out, K, n_samples = check_sweep_shapes(
        caps, src_rate, g_frac, g_slot, hops, structure, steps, sample_every,
        s0)
    dev = caps.device
    for name, t in (("caps", caps), ("src_rate", src_rate),
                    ("g_frac", g_frac), ("hops", hops),
                    ("edge_mult", structure.edge_mult)):
        check_operand(name, t, torch.float64, dev, align=8)
    for name, t in (("g_slot", g_slot), ("row_off", structure.row_off),
                    ("edge_off", structure.edge_off),
                    ("edge_src", structure.edge_src),
                    ("sink_off", structure.sink_off),
                    ("sink_rows", structure.sink_rows)):
        check_operand(name, t, torch.int32, dev, align=4)
    f64 = dict(dtype=torch.float64, device=dev)
    out = SweepOutputs(
        queues=torch.zeros((C, G, K), **f64),
        busy=torch.zeros((C, S, K), **f64),
        served=torch.zeros((C, G, K), **f64),
        realized=torch.zeros((C, T, K), **f64),
        latency=torch.zeros((C, n_samples, n_out, K), **f64))
    best = torch.zeros((C, T, K), **f64)
    fn = build()["fn"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(caps.data_ptr(), src_rate.data_ptr(), g_frac.data_ptr(),
             g_slot.data_ptr(), hops.data_ptr(), structure.row_off.data_ptr(),
             structure.edge_off.data_ptr(), structure.edge_src.data_ptr(),
             structure.edge_mult.data_ptr(), structure.sink_off.data_ptr(),
             structure.sink_rows.data_ptr(), out.queues.data_ptr(),
             out.busy.data_ptr(), out.served.data_ptr(),
             out.realized.data_ptr(), out.latency.data_ptr(), best.data_ptr(),
             C, T, G, S, n_out, K, n_samples, steps, sample_every, s0,
             float(dt), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"sweep_scan launch failed: cudaError_t {err}")
    global _launches
    with _LOCK:
        _launches += 1
    return out
