"""Binds and launches the Hopper flash-attention forward kernel.

``csrc/flash_fwd.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels.nvcc`).  Nothing is built or imported from CUDA
when this module is imported.

:func:`flash_attention_fwd` takes the kernel's layout, q (B, H, Sq, hd) and
k/v (B, K, Skv, hd) with hd 64 or 128, causal or not, and counts every
launch in either mode.  The entry point picks the kernel by dtype: bf16 runs
on the tensor cores, fp32 on the scalar FMA kernel; both take the same
shapes and both modes.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional

import torch

from ..nvcc import build_library, check_operand

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
SUPPORTED_HD = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

_LOCK = threading.Lock()
#: the loaded library and its build record, filled on first use
_LIB: Dict[str, object] = {}
_launches = 0


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library.

    Returns the build record: ``path``, ``seconds`` spent compiling (0.0 when
    a library built from the same source was found) and ``ptxas``, the
    compiler's register/shared-memory report.
    """
    with _LOCK:
        if "lib" not in _LIB:
            _LIB.update(build_library(CSRC, "repro_flash_fwd", _ARGTYPES))
        return _LIB


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    with _LOCK:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _LOCK:
        _launches = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_offset: Optional[torch.Tensor] = None,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention.  q: (B, H, Sq, hd)  k/v: (B, K, Skv, hd) with H = G*K,
    on one CUDA device, float32 or bfloat16, hd in (64, 128).  Causal, query
    row i sees keys j <= q_offset[b] + i; with ``causal=False`` it sees
    every key and ``q_offset`` plays no part.  Returns (B, H, Sq, hd) in
    q's dtype, launched on the current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}; expected one of "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} do not "
                         "form a GQA group")
    if hd not in SUPPORTED_HD:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HD} (the kernels' "
                         "tile widths); pad it")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, q.dtype, q.device)
    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=q.device)
    check_operand("q_offset", q_offset, torch.int32, q.device, align=4)
    if q_offset.shape != (B,):
        raise ValueError(f"q_offset must be ({B},), got {tuple(q_offset.shape)}")
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    fn = build()["fn"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             q_offset.data_ptr(), B, H, K, Sq, Skv, hd, _DTYPE_CODE[q.dtype],
             int(bool(causal)), float(sm_scale), q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    global _launches
    with _LOCK:
        _launches += 1
    return out
