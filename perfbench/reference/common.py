"""What the families' plain forwards share: float32 with TF32 off, RMS
norm with a ``1 + w`` gain, and the one precision switch the control
uses (``quant="fp8"``: every projection's weight and input rounded to
float8 e4m3, each row scaled to its largest magnitude, then multiplied in
float32)."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """Matrix products in true float32 (no TF32) while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per row, back in fp32."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str] = None
           ) -> torch.Tensor:
    """``x @ w.T`` for a weight in (out, in) layout, in float32."""
    w = w.float()
    if quant == "fp8":
        x, w = fp8_rows(x), fp8_rows(w)
    elif quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return x @ w.T


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + gain.float())


def head(x: torch.Tensor, weights, sizes, quant: Optional[str]
         ) -> torch.Tensor:
    """Logits of the final-normed rows ``x``: the embedding table when
    tied, else ``head``."""
    table = weights["embed" if sizes["tie_embeddings"] else "head"]
    return linear(rms_norm(x, weights["final_norm"], sizes["norm_eps"]),
                  table, quant)
