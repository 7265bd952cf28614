"""Binds and launches the Hopper stream-operator kernels.

``csrc/stream_ops.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C entry point per kernel at first use and
loaded with ``ctypes`` (:mod:`repro_torch.kernels.nvcc`).  Nothing is
built or imported from CUDA when this module is imported.

Each wrapper checks its operands (CUDA, dtype, contiguous), allocates its
outputs on the operand's device, launches once on PyTorch's current
stream of that device and counts the launch under its kernel's name
(:data:`KERNELS`).  A part of zero tuples launches nothing.  The shapes
and numerics are :mod:`.ref`'s.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from ..nvcc import build_library, check_operand
from .ref import PI_ITERATIONS, SERVICE_WORK

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "stream_ops.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: kernel name -> (C entry point, its argument types)
_ENTRIES = {
    "parse_xml": ("repro_parse_xml", [_P, _I, _I, _P, _P, _I, _P]),
    "viete_pi": ("repro_viete_pi", [_I, _I, _P, _I, _P]),
    "rolling_digest": ("repro_rolling_digest", [_P, _I, _I, _P, _I, _P]),
    "external_service": ("repro_external_service", [_P, _I, _I, _P, _I, _P]),
}
KERNELS = tuple(_ENTRIES)

_LOCK = threading.Lock()
#: the loaded library, its build record and its entry points (``fns``)
_LIB: Dict[str, object] = {}
_launches = dict.fromkeys(KERNELS, 0)


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library; returns the build
    record (``path``, compile ``seconds``, ``ptxas`` report, ``fns``: the
    four bound entry points by kernel name)."""
    with _LOCK:
        if "lib" not in _LIB:
            entry, argtypes = _ENTRIES["parse_xml"]
            record = build_library(CSRC, entry, argtypes)
            fns = {}
            for name, (entry, argtypes) in _ENTRIES.items():
                fn = getattr(record["lib"], entry)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                fns[name] = fn
            _LIB.update(record, fns=fns)
        return _LIB


def launch_count(name: Optional[str] = None) -> Union[int, Dict[str, int]]:
    """Launches of kernel ``name`` since the last :func:`reset_launch_count`,
    or all four by name."""
    with _LOCK:
        return dict(_launches) if name is None else _launches[name]


def reset_launch_count() -> None:
    with _LOCK:
        for name in _launches:
            _launches[name] = 0


def _launch(name: str, dev: torch.device, *args) -> None:
    fn = build()["fns"][name]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*args, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    with _LOCK:
        _launches[name] += 1


def _cuda(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, {name} is on "
                         f"{t.device}")
    return t.device


def parse_xml_fwd(payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tags, checksum), each (B,) int32, of a (B, L) uint8 payload."""
    dev = _cuda("payload", payload)
    if payload.dim() != 2:
        raise ValueError(f"payload must be (B, L), got {tuple(payload.shape)}")
    check_operand("payload", payload, torch.uint8, dev, align=1)
    B, L = payload.shape
    tags = torch.empty((B,), dtype=torch.int32, device=dev)
    checksum = torch.empty((B,), dtype=torch.int32, device=dev)
    if B and L:
        _launch("parse_xml", dev, payload.data_ptr(), B, L, tags.data_ptr(),
                checksum.data_ptr())
    else:
        tags.zero_()
        checksum.zero_()
    return tags, checksum


def viete_pi_fwd(value: torch.Tensor,
                 iterations: int = PI_ITERATIONS) -> torch.Tensor:
    """(B,) float32 pi for each of ``value``'s B tuples, on its device."""
    dev = _cuda("value", value)
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    B = value.shape[0]
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        _launch("viete_pi", dev, B, iterations, out.data_ptr())
    return out


def rolling_digest_fwd(x: torch.Tensor) -> torch.Tensor:
    """(B,) float32 running digest of a (B,) float32 or int32 column."""
    dev = _cuda("x", x)
    if x.dim() != 1 or x.dtype not in (torch.float32, torch.int32):
        raise TypeError("the digest takes a (B,) float32 or int32 column, "
                        f"got {x.dtype} {tuple(x.shape)}")
    check_operand("x", x, x.dtype, dev, align=4)
    B = x.shape[0]
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        _launch("rolling_digest", dev, x.data_ptr(),
                int(x.dtype == torch.int32), B, out.data_ptr())
    return out


def external_service_fwd(v: torch.Tensor,
                         work: int = SERVICE_WORK) -> torch.Tensor:
    """(B,) float32: the service chain from the sum of a (B,) float32
    column, for every tuple."""
    dev = _cuda("v", v)
    if v.dim() != 1:
        raise ValueError(f"v must be (B,), got {tuple(v.shape)}")
    if work < 0:
        raise ValueError("work must be >= 0")
    check_operand("v", v, torch.float32, dev, align=4)
    B = v.shape[0]
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        _launch("external_service", dev, v.data_ptr(), B, work, out.data_ptr())
    return out
