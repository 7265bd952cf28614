"""Binds and launches the Hopper SSD-scan forward kernel.

``csrc/ssd_fwd.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels.nvcc`).  Nothing is built or imported from CUDA
when this module is imported.

:func:`ssd_scan_fwd` takes the model layout (x (Bt, S, H, P), dt (Bt, S, H),
A (H,), B/C (Bt, S, N) or, in G groups, (Bt, S, G, N)), allocates the
outputs and the two scratch buffers the kernel's passes share, and counts
every call: one call is one launch of the C entry point, which runs the
kernel's three passes.  The entry point
picks the passes by dtype: bf16 runs the tensor-core passes, which take P
and N multiples of 16 (:func:`check_tensor_core_shape`), fp32 the scalar
ones.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional, Tuple

import torch

from ..nvcc import build_library, check_operand

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
MAX_P, MAX_N, MAX_Q = 64, 256, 4096
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

_LOCK = threading.Lock()
#: the loaded library and its build record, filled on first use
_LIB: Dict[str, object] = {}
_launches = 0


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library; returns the build
    record (``path``, compile ``seconds``, ``ptxas`` report)."""
    with _LOCK:
        if "lib" not in _LIB:
            _LIB.update(build_library(CSRC, "repro_ssd_fwd", _ARGTYPES))
        return _LIB


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    with _LOCK:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _LOCK:
        _launches = 0


def check_tensor_core_shape(P: int, N: int) -> None:
    """Raise ValueError unless the bf16 tensor-core passes take (P, N):
    both multiples of 16 (the mma.sync tile), P <= 64 and N <= 256."""
    if P % 16 or N % 16 or not (P <= MAX_P and N <= MAX_N):
        raise ValueError(f"the bf16 tensor-core SSD kernel needs P and N "
                         f"multiples of 16 with P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P={P}, N={N}")


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD forward on one CUDA device.

    x: (Bt, S, H, P) float32 or bfloat16; dt: (Bt, S, H) float32; A: (H,)
    float32; B/C: (Bt, S, N), or (Bt, S, G, N) with G dividing H (head h
    reads group h // (H / G)), in x's dtype; init_state: (Bt, H, P, N)
    float32 or None (zeros).  The chunk length is Q = min(chunk, S); the
    last chunk may be shorter.  Returns y (Bt, S, H, P) in x's dtype and
    the final state (Bt, H, P, N) float32, launched on the current stream.
    """
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}; expected one of "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if x.ndim != 4:
        raise ValueError(f"x must be (Bt, S, H, P), got {tuple(x.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    G = B.shape[2] if B.ndim == 4 else 1
    if (dt.shape != (Bt, S, H) or A.shape != (H,) or C.shape != B.shape
            or B.shape not in ((Bt, S, N), (Bt, S, G, N)) or H % G):
        raise ValueError(f"bad shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"A{tuple(A.shape)} B{tuple(B.shape)} "
                         f"C{tuple(C.shape)}")
    Q = min(int(chunk), S)
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and 1 <= Q <= MAX_Q):
        raise ValueError(f"P={P}, N={N}, Q={Q} outside the kernel's range "
                         f"(P <= {MAX_P}, N <= {MAX_N}, 1 <= Q <= {MAX_Q})")
    if x.dtype == torch.bfloat16:
        check_tensor_core_shape(P, N)
    dev = x.device
    for name, t in (("x", x), ("B", B), ("C", C)):   # bf16 rows go by cp.async
        check_operand(name, t, x.dtype, dev,
                      align=16 if x.dtype == torch.bfloat16 else 4)
    for name, t in (("dt", dt), ("A", A)):
        check_operand(name, t, torch.float32, dev, align=4)
    if init_state is not None:
        if init_state.shape != (Bt, H, P, N):
            raise ValueError(f"init_state must be {(Bt, H, P, N)}, got "
                             f"{tuple(init_state.shape)}")
        check_operand("init_state", init_state, torch.float32, dev, align=4)
    nc = -(-S // Q)
    y = torch.empty_like(x)
    final_state = torch.empty((Bt, H, P, N), dtype=torch.float32, device=dev)
    cum = torch.empty((Bt, H, S), dtype=torch.float32, device=dev)
    states = torch.empty((Bt, H, nc, P, N), dtype=torch.float32, device=dev)
    fn = build()["fn"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), None if init_state is None else init_state.data_ptr(),
             y.data_ptr(), final_state.data_ptr(), cum.data_ptr(),
             states.data_ptr(), Bt, S, H, P, N, G, Q, _DTYPE_CODE[x.dtype],
             dev.index, stream)
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: cudaError_t {err}")
    global _launches
    with _LOCK:
        _launches += 1
    return y, final_state
