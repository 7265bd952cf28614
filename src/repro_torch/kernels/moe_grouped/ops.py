"""The grouped relu^2 expert FFN, dispatched on the tensors' device.

``grouped_relu2(x, rows, dest, scale, offsets, wu, wd)`` (shapes in
:mod:`.ref`): on CUDA tensors it launches the CUDA kernels
(:mod:`.kernel`) or raises; on CPU (and meta) tensors it runs the plain
PyTorch version (:mod:`.ref`).  There is no fallback from one to the
other.  The kernels have no backward: training runs the plain version on
the CPU, as the models' forward there does.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import grouped_relu2 as _plain


def grouped_relu2(x: torch.Tensor, rows: torch.Tensor, dest: torch.Tensor,
                  scale: torch.Tensor, offsets: torch.Tensor,
                  wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return kernel.grouped_relu2_fwd(
            x.contiguous(), rows, dest, scale, offsets.to(torch.int32),
            wu.contiguous(), wd.contiguous())
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"grouped_relu2 runs on cuda, cpu or meta, not "
                         f"{x.device}")
    return _plain(x, rows, dest, scale, offsets, wu, wd)
