"""Binds and launches the Hopper split-KV decode-attention kernels.

``csrc/decode_attn.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point at first use and loaded with
``ctypes`` (:mod:`repro_torch.kernels.nvcc`).  Nothing is built or imported
from CUDA when this module is imported.

:func:`decode_attention_fwd` takes one query a sequence and the cache in
its own layout and strides, chooses the split of the keys
(:func:`split_plan`), allocates the splits' scratch and the output, and
counts every call: one call is one launch of the C entry point, which
launches ``decode_attn_split_kernel`` then ``decode_attn_combine_kernel``.
The grid is fixed by the shapes and the lengths are read on the device, so
a decode step stays capturable as one CUDA graph.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Tuple

import torch

from ..nvcc import build_library, check_operand

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "decode_attn.cu"
SUPPORTED_HD = (64, 96, 112, 128)
#: keys a tile; a split's keys are a multiple of it
TILE = 32
#: the fewest keys a split takes while the cache has more
MIN_SPLIT_KEYS = 256
#: blocks (one warp each) per SM the split count aims for
BLOCKS_PER_SM = 32
#: the most query heads a block takes (the rest of a group go to more blocks)
MAX_GROUP = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_longlong] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

_LOCK = threading.Lock()
#: the loaded library and its build record, filled on first use
_LIB: Dict[str, object] = {}
_launches = 0


def build() -> Dict[str, object]:
    """Compile (if needed) and load the kernel library; returns the build
    record (``path``, compile ``seconds``, ``ptxas`` report)."""
    with _LOCK:
        if "lib" not in _LIB:
            _LIB.update(build_library(CSRC, "repro_decode_attn", _ARGTYPES))
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


def split_plan(B: int, K: int, G: int, S: int,
               sms: int) -> Tuple[int, int, int, int]:
    """(gb, groups, nsplit, chunk) for B sequences of K KV heads, G query
    heads each, over a cache of S positions on a card of ``sms`` SMs.

    A block takes ``gb`` of a KV head's query heads (1 for G = 1, else the
    power of two at or above G, at least 4 and at most ``MAX_GROUP``;
    ``groups`` blocks cover the G) and one
    split of ``chunk`` keys (a multiple of ``TILE``).  The split count aims
    at ``BLOCKS_PER_SM`` blocks an SM, but leaves each split at least
    ``MIN_SPLIT_KEYS`` keys; the last split is never empty at S."""
    gb = 1 if G == 1 else max(4, 1 << (min(G, MAX_GROUP) - 1).bit_length())
    groups = -(-G // gb)
    blocks = B * K * groups
    nsplit = max(1, min(-(-BLOCKS_PER_SM * sms // blocks),
                        -(-S // MIN_SPLIT_KEYS)))
    chunk = -(-S // nsplit)
    chunk = -(-chunk // TILE) * TILE
    return gb, groups, -(-S // chunk), chunk


def _check_cache(name: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device) -> None:
    """The kernel reads ``t`` through its strides: its last dimension
    contiguous, its data and every stride a whole number of 16 bytes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    size = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(
            t.stride(i) * size % 16 for i in range(3)):
        raise ValueError(f"{name} must have unit last stride and 16-byte "
                         f"aligned rows, got strides {t.stride()}")


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, hd) contiguous; k/v (B, S, K, hd) with H = G*K, in their
    own strides; kv_len (B,) int64: sequence b attends to its keys below
    kv_len[b].  float32 or bfloat16 on one CUDA device, hd in
    ``SUPPORTED_HD``.  Returns (B, 1, H, hd) in q's dtype, launched on the
    current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}; expected one of "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or q.shape[1] != 1:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}: one query over a cache")
    B, _, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K or S == 0:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} do not "
                         "form a GQA group over a cache")
    if hd not in SUPPORTED_HD:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HD}")
    dev = q.device
    check_operand("q", q, q.dtype, dev)
    _check_cache("k", k, q.dtype, dev)
    _check_cache("v", v, q.dtype, dev)
    if kv_len.shape != (B,):
        raise ValueError(f"kv_len must be ({B},), got {tuple(kv_len.shape)}")
    kv_len = kv_len.to(torch.int64).contiguous()
    check_operand("kv_len", kv_len, torch.int64, dev, align=8)
    G = H // K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gb, groups, nsplit, chunk = split_plan(B, K, G, S, sms)
    part_o = torch.empty((B, H, nsplit, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    fn = build()["fn"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
             B, S, K, G, hd, gb, groups, nsplit, chunk,
             *k.stride()[:3], *v.stride()[:3], float(hd ** -0.5),
             _DTYPE_CODE[q.dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: cudaError_t {err}")
    global _launches
    with _LOCK:
        _launches += 1
    return out
