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

* ``parse_xml`` takes one of two paths of its kernel, chosen here once a
  launch (:func:`parse_xml_lanes`) and counted apart
  (:func:`parse_xml_path_count`): the vector path where the payload is
  16-byte aligned and a row a multiple of 16 bytes (16-byte loads, a lane
  a chunk, 16 lanes a row of 256 bytes), else the byte path (a warp a
  row).  Its two outputs are the rows of one (2, B) int32 tensor.
* ``rolling_digest`` takes a part of any length: up to
  :func:`digest_reach` tuples in one block, a longer one level by level,
  the tile totals of each level past one block's reach in scratch
  allocated here, of the size the C library gives
  (:func:`digest_scratch_floats`).  Its C entry point then runs a kernel a
  pass; the call still counts as one launch.

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
from .ref import PI_ITERATIONS, SERVICE_WORK

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "stream_ops.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: kernel name -> (C entry point, its argument types)
_ENTRIES = {
    "parse_xml": ("repro_parse_xml", [_P, _I, _I, _I, _P, _P, _I, _P]),
    "viete_pi": ("repro_viete_pi", [_I, _I, _P, _I, _P]),
    "rolling_digest": ("repro_rolling_digest",
                       [_P, _I, _I, _P, _P, ctypes.c_longlong, _I, _P]),
    "external_service": ("repro_external_service", [_P, _I, _I, _P, _I, _P]),
}
KERNELS = tuple(_ENTRIES)
#: the digest's scratch size in floats for a part of B (stream_ops.cu
#: lays the levels out; 0 within one block's reach)
_DIGEST_SCRATCH = ("repro_rolling_digest_scratch_floats", [_I])
#: parse_xml's two paths (stream_ops.cu)
PARSE_XML_PATHS = ("vector", "byte")
#: bytes a lane of parse_xml's vector path loads at once, and its lanes a
#: row at most
PARSE_XML_CHUNK, PARSE_XML_MAX_LANES = 16, 32

_LOCK = threading.Lock()
#: the loaded library and its build record; ``bound``: the entry points by
#: kernel name, ``stream`` (device index -> raw stream) and
#: ``digest_scratch``; ``digest_reach``: the longest part the digest takes
#: in one block
_LIB: Dict[str, object] = {}
_launches = dict.fromkeys(KERNELS, 0)
_paths = dict.fromkeys(PARSE_XML_PATHS, 0)


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library; returns the build
    record (``path``, compile ``seconds``, ``ptxas`` report, ``bound``: the
    four entry points by kernel name, ``stream``, the stream getter, and
    ``digest_scratch``; ``digest_reach``)."""
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
            entry, argtypes = _DIGEST_SCRATCH
            fn = getattr(record["lib"], entry)
            fn.restype = ctypes.c_longlong
            fn.argtypes = argtypes
            bound["digest_scratch"] = fn
            reach = ctypes.c_int.in_dll(record["lib"],
                                        "repro_rolling_digest_reach").value
            _LIB.update(record, bound=bound, digest_reach=reach)
        return _LIB


def launch_count(name: Optional[str] = None) -> Union[int, Dict[str, int]]:
    """Launches of kernel ``name`` since the last :func:`reset_launch_count`,
    or all four by name."""
    with _LOCK:
        return dict(_launches) if name is None else _launches[name]


def parse_xml_path_count() -> Dict[str, int]:
    """parse_xml's launches since the last :func:`reset_launch_count`, by
    path (:data:`PARSE_XML_PATHS`)."""
    with _LOCK:
        return dict(_paths)


def reset_launch_count() -> None:
    with _LOCK:
        for counts in (_launches, _paths):
            for name in counts:
                counts[name] = 0


def _launch(name: str, index: int, *args, path: Optional[str] = None
            ) -> None:
    bound = _LIB.get("bound") or build()["bound"]
    err = bound[name](*args, index, bound["stream"](index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    with _LOCK:
        _launches[name] += 1
        if path is not None:
            _paths[path] += 1


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


def parse_xml_lanes(address: int, L: int) -> int:
    """parse_xml's lanes a row for a payload at ``address`` with rows of
    ``L`` bytes: on the vector path (the address 16-byte aligned, L a
    multiple of 16) a power of two, one lane a chunk of 16 bytes up to 32
    lanes; 0 for the byte path."""
    if L % PARSE_XML_CHUNK or address % PARSE_XML_CHUNK:
        return 0
    return min(PARSE_XML_MAX_LANES,
               1 << (L // PARSE_XML_CHUNK - 1).bit_length())


def digest_reach() -> int:
    """The longest part the digest takes in one block, with no scratch
    (stream_ops.cu's ``kDigestReach``); builds the library if needed."""
    return (_LIB if "bound" in _LIB else build())["digest_reach"]


def digest_scratch_floats(B: int) -> int:
    """float32 scratch the digest takes for a part of B: the tile totals of
    each level past one block's reach, 0 within it, as stream_ops.cu's
    ``launch_digest`` lays them out; builds the library if needed."""
    lib = _LIB if "bound" in _LIB else build()
    return lib["bound"]["digest_scratch"](B) if B > lib["digest_reach"] else 0


def parse_xml_fwd(payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tags, checksum), each (B,) int32, of a (B, L) uint8 payload: the
    two rows of one (2, B) tensor."""
    index = _operand("payload", payload, (torch.uint8,), 2)
    B, L = payload.shape
    out = payload.new_empty((2, B), dtype=torch.int32)
    if B and L:
        address, rows = payload.data_ptr(), out.data_ptr()
        lanes = parse_xml_lanes(address, L)
        _launch("parse_xml", index, address, B, L, lanes, rows, rows + 4 * B,
                path="vector" if lanes else "byte")
    else:
        out.zero_()
    return out.unbind()


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
    out = x.new_empty((B,), dtype=torch.float32)
    if B:
        n = digest_scratch_floats(B)
        # freed on return: the caching allocator hands it on only to work
        # queued after this launch on the same stream
        scratch = x.new_empty((n,), dtype=torch.float32) if n else None
        _launch("rolling_digest", index, x.data_ptr(),
                int(x.dtype == torch.int32), B, out.data_ptr(),
                scratch.data_ptr() if n else None, n)
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
