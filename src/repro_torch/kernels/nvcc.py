"""Builds a kernel source with ``nvcc`` and loads its plain C entry point.

Every hand-written kernel of the port takes this route: its ``csrc/*.cu``
is compiled for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` in the repository at first use, and its
entry point is bound with ``ctypes``.  Sources include the shared
headers of ``kernels/csrc/`` (``tensor_core.cuh``) and may include the
other sources beside them.  The library's name carries a hash of the
source, those headers and sources and the flags, so an edited source or
header is rebuilt and a built one is reused; a finished build
is moved into place atomically, so processes that build at once agree.
Nothing is built when this module is imported.

:func:`check_operand` holds the checks every wrapper makes before it hands
a tensor's pointer to a kernel.  The helper keeps no state: each kernel
module keeps its loaded library and launch count under its own lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Sequence

import torch

#: the repository root (src/repro_torch/kernels/nvcc.py)
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
#: headers shared by the kernels' sources (``#include "tensor_core.cuh"``)
INCLUDE_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: names the built library: a changed source or flag set builds anew
_FLAGS_KEY = "|".join(NVCC_FLAGS).encode()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found on PATH: the port's kernels are "
                           "built from source with the CUDA toolkit")
    return found


def build_library(csrc: pathlib.Path, entry: str,
                  argtypes: Sequence[type]) -> Dict[str, object]:
    """Compile ``csrc`` (if no library of the same source and flags exists)
    and load it.

    Returns the build record: ``lib``, ``fn`` (the C function ``entry``,
    returning an int, with ``argtypes``), ``path``, ``seconds`` spent
    compiling (0.0 when the library was found) and ``ptxas``, the
    compiler's register/shared-memory report."""
    stem = csrc.stem
    digest = hashlib.sha256(csrc.read_bytes())
    beside = {*csrc.parent.glob("*.cu"), *csrc.parent.glob("*.cuh")} - {csrc}
    for dep in (*sorted(INCLUDE_DIR.glob("*.cuh")), *sorted(beside)):
        digest.update(dep.read_bytes())
    digest.update(_FLAGS_KEY)
    tag = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{stem}-{tag}.so"
    log = BUILD_DIR / f"{stem}-{tag}.ptxas.txt"
    seconds = 0.0
    if not so.exists():
        tmp = BUILD_DIR / f".{stem}-{tag}-{os.getpid()}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR),
                               "-o", str(tmp), str(csrc)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc.name} ({proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)   # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return dict(lib=lib, fn=fn, path=str(so), seconds=seconds,
                ptxas=log.read_text() if log.exists() else "")


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  device: torch.device, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    whose data starts on an ``align``-byte boundary."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
