"""Weights from the reference's parameter tree into the port's layout.

This is the one place where layouts change: the reference keeps projections
as (in, out) matrices stacked on a leading layer axis; the port keeps one
dict per layer with (out, in) matrices for ``F.linear``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig

Params = Dict[str, Any]

_ATTN = ("wq", "wk", "wv", "wo")
_BIAS = ("bq", "bk", "bv")
_MLP = ("wg", "wu", "wd")


def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device, dtype: torch.dtype) -> Params:
    """``np_params``: the reference's dense-family tree as numpy arrays —
    ``embed`` (V, D), ``blocks.{ln1, ln2, attn.{wq,wk,wv,wo}, mlp.{wg,wu,wd}}``
    stacked on a leading L axis, ``final_norm`` (D,) and, untied, ``head``
    (D, V).  Returns the port's params on ``device`` in ``dtype``."""
    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def linear(a: np.ndarray) -> torch.Tensor:
        return t(np.swapaxes(a, -1, -2))        # (in, out) -> (out, in)

    blocks = np_params["blocks"]
    out: Params = {"embed": t(np_params["embed"]), "blocks": []}
    for i in range(cfg.num_layers):
        attn = {name: linear(blocks["attn"][name][i]) for name in _ATTN}
        attn.update({name: t(blocks["attn"][name][i]) for name in _BIAS
                     if name in blocks["attn"]})
        out["blocks"].append({
            "ln1": t(blocks["ln1"][i]),
            "attn": attn,
            "ln2": t(blocks["ln2"][i]),
            "mlp": {name: linear(blocks["mlp"][name][i]) for name in _MLP},
        })
    out["final_norm"] = t(np_params["final_norm"])
    if "head" in np_params:
        out["head"] = linear(np_params["head"])
    return out
