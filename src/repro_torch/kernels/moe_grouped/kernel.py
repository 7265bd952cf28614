"""Binds and launches the Hopper grouped relu^2 expert kernels.

``csrc/moe_grouped.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point at first use and loaded with
``ctypes`` (:mod:`repro_torch.kernels.nvcc`).  Nothing is built or imported
from CUDA when this module is imported.

:func:`grouped_relu2_fwd` takes the rows sorted by expert and the experts'
row offsets on the device, allocates ``h`` and the output, and counts every
call: one call is one launch of the C entry point, which launches
``moe_grouped_up_kernel`` then ``moe_grouped_down_kernel``.  The grid is
fixed by the shapes alone, (experts, column tiles), so the decode step stays
capturable as one CUDA graph.  bf16 runs on the tensor cores and takes D and
F multiples of 8; fp32 runs scalar FMA.
"""

import ctypes
import pathlib
import threading
from typing import Dict

import torch

from ..nvcc import build_library, check_operand

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "moe_grouped.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

_LOCK = threading.Lock()
#: the loaded library and its build record, filled on first use
_LIB: Dict[str, object] = {}
_launches = 0


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library; returns the build
    record (``path``, compile ``seconds``, ``ptxas`` report)."""
    with _LOCK:
        if "lib" not in _LIB:
            _LIB.update(build_library(CSRC, "repro_moe_grouped", _ARGTYPES))
        return _LIB


def launch_count() -> int:
    """Calls since the last :func:`reset_launch_count` (one call launches
    both kernels)."""
    with _LOCK:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _LOCK:
        _launches = 0


def rows_per_program(n_rows: int, n_experts: int) -> int:
    """``BM``: the rows a block takes at a time, from the mean an expert
    gets (16 at decode, up to 64 for long prompts)."""
    mean = n_rows / max(1, n_experts)
    return 16 if mean <= 16 else 32 if mean <= 32 else 64


def grouped_relu2_fwd(x: torch.Tensor, rows: torch.Tensor, dest: torch.Tensor,
                      scale: torch.Tensor, offsets: torch.Tensor,
                      wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """x (n, D) bf16 or fp32; rows, dest (n*k,) int64 (a sorted row's token,
    and its place in the output); scale (n*k,) fp32; offsets (E + 1,)
    int32; wu (E, D, F), wd (E, F, D) in x's dtype; all contiguous on one
    CUDA device.  Returns (n*k, D) fp32, launched on the current stream."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}; expected one of "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    n, D = x.shape
    E, F = wu.shape[0], wu.shape[2]
    nk = rows.shape[0]
    if (wu.shape != (E, D, F) or wd.shape != (E, F, D)
            or offsets.shape != (E + 1,) or dest.shape != (nk,)
            or scale.shape != (nk,)):
        raise ValueError(f"bad shapes x{tuple(x.shape)} wu{tuple(wu.shape)} "
                         f"wd{tuple(wd.shape)} offsets{tuple(offsets.shape)} "
                         f"rows{tuple(rows.shape)} dest{tuple(dest.shape)} "
                         f"scale{tuple(scale.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (D % 8 or F % 8):
        raise ValueError(f"the bf16 kernel needs D and F multiples of 8, got "
                         f"D={D}, F={F}")
    dev = x.device
    align = 16 if bf16 else 4          # bf16 rows go by 16-byte cp.async
    for name, t in (("x", x), ("wu", wu), ("wd", wd)):
        check_operand(name, t, x.dtype, dev, align=align)
    for name, t, dt in (("rows", rows, torch.int64),
                        ("dest", dest, torch.int64),
                        ("scale", scale, torch.float32),
                        ("offsets", offsets, torch.int32)):
        check_operand(name, t, dt, dev, align=4)
    h = torch.empty((nk, F), dtype=x.dtype, device=dev)
    out = torch.empty((nk, D), dtype=torch.float32, device=dev)
    fn = build()["fn"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), rows.data_ptr(), dest.data_ptr(), scale.data_ptr(),
             offsets.data_ptr(), wu.data_ptr(), wd.data_ptr(), h.data_ptr(),
             out.data_ptr(), E, D, F, rows_per_program(nk, E),
             _DTYPE_CODE[x.dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"moe_grouped launch failed: cudaError_t {err}")
    global _launches
    with _LOCK:
        _launches += 1
    return out
