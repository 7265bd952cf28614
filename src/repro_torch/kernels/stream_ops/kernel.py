"""Binds and launches the Hopper stream-operator kernels.

``csrc/stream_ops.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C entry point per kernel at first use and
loaded with ``ctypes`` (:mod:`repro_torch.kernels.nvcc`).  Nothing is
built or imported from CUDA when this module is imported.

Each wrapper checks its operand (CUDA, dtype, shape, contiguous,
aligned), allocates its output on the operand's device, launches once on
PyTorch's current stream of that device and counts the launch under its
kernel's name (:data:`KERNELS`).  A part of zero tuples launches nothing.
The shapes and numerics are :mod:`.ref`'s, bit for bit.

A launch costs the card 1-2 us and the host far more, so the per-call
path is short: the entry points and the stream getter are bound once,
after the build; a call reads them without a lock, takes its operand's
device index from the tensor (the output goes to the same device, so no
two devices are compared) and takes one lock, to count the launch.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from ..nvcc import build_library
from .ref import PI_ITERATIONS, SCAN_TILE, SERVICE_WORK

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
#: the dynamic shared memory a block gets without opting in: the digest's
#: tile totals must fit it
DIGEST_SHARED_LIMIT = 48 * 1024

_LOCK = threading.Lock()
#: the loaded library and its build record; ``bound``: the entry points by
#: kernel name and ``stream`` (device index -> raw stream)
_LIB: Dict[str, object] = {}
_launches = dict.fromkeys(KERNELS, 0)


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library; returns the build
    record (``path``, compile ``seconds``, ``ptxas`` report, ``bound``: the
    four entry points by kernel name and ``stream``, the stream getter)."""
    with _LOCK:
        if "lib" not in _LIB:
            entry, argtypes = _ENTRIES["parse_xml"]
            record = build_library(CSRC, entry, argtypes)
            bound = {}
            for name, (entry, argtypes) in _ENTRIES.items():
                fn = getattr(record["lib"], entry)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                bound[name] = fn
            # device index -> the raw cudaStream_t of PyTorch's current
            # stream there (torch.cuda.current_stream builds a Stream object)
            bound["stream"] = torch._C._cuda_getCurrentRawStream
            _LIB.update(record, bound=bound)
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


def _launch(name: str, index: int, *args) -> None:
    bound = _LIB.get("bound") or build()["bound"]
    err = bound[name](*args, index, bound["stream"](index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    with _LOCK:
        _launches[name] += 1


def _operand(what: str, t: torch.Tensor, dtypes: Tuple[torch.dtype, ...],
             dim: int) -> int:
    """The device index of ``t``, once it is a contiguous, element-aligned
    CUDA tensor of ``dim`` dimensions and one of ``dtypes``; else raise."""
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, {what} is on "
                         f"{t.device}")
    if t.dim() != dim:
        raise ValueError(f"{what} must have {dim} dimension(s), got "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"{what} must be {t.element_size()}-byte aligned")
    return t.get_device()


def digest_shared_bytes(B: int) -> int:
    """Shared memory the digest kernel takes for a part of B: the tile
    totals of every level above the part (stream_ops.cu)."""
    total = 0
    while B > SCAN_TILE:
        B = -(-B // SCAN_TILE)
        total += B
    return 4 * total


def parse_xml_fwd(payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tags, checksum), each (B,) int32, of a (B, L) uint8 payload."""
    index = _operand("payload", payload, (torch.uint8,), 2)
    B, L = payload.shape
    tags = payload.new_empty((B,), dtype=torch.int32)
    checksum = payload.new_empty((B,), dtype=torch.int32)
    if B and L:
        _launch("parse_xml", index, payload.data_ptr(), B, L, tags.data_ptr(),
                checksum.data_ptr())
    else:
        tags.zero_()
        checksum.zero_()
    return tags, checksum


def viete_pi_fwd(value: torch.Tensor,
                 iterations: int = PI_ITERATIONS) -> torch.Tensor:
    """(B,) float32 pi for each of ``value``'s B tuples, on its device."""
    if not value.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, value is on "
                         f"{value.device}")
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    B = value.shape[0]
    out = value.new_empty((B,), dtype=torch.float32)
    if B:
        _launch("viete_pi", value.get_device(), B, iterations, out.data_ptr())
    return out


def rolling_digest_fwd(x: torch.Tensor) -> torch.Tensor:
    """(B,) float32 running digest of a (B,) float32 or int32 column."""
    index = _operand("x", x, (torch.float32, torch.int32), 1)
    B = x.shape[0]
    if B > SCAN_TILE and digest_shared_bytes(B) > DIGEST_SHARED_LIMIT:
        raise ValueError(f"a part of {B} tuples needs "
                         f"{digest_shared_bytes(B)} B of shared memory for "
                         f"its tile totals; the digest kernel takes at most "
                         f"{DIGEST_SHARED_LIMIT}")
    out = x.new_empty((B,), dtype=torch.float32)
    if B:
        _launch("rolling_digest", index, x.data_ptr(),
                int(x.dtype == torch.int32), B, out.data_ptr())
    return out


def external_service_fwd(v: torch.Tensor,
                         work: int = SERVICE_WORK) -> torch.Tensor:
    """(B,) float32: the service chain from the sum of a (B,) float32
    column, for every tuple."""
    index = _operand("v", v, (torch.float32,), 1)
    if work < 0:
        raise ValueError("work must be >= 0")
    B = v.shape[0]
    out = torch.empty_like(v)
    if B:
        _launch("external_service", index, v.data_ptr(), B, work,
                out.data_ptr())
    return out
