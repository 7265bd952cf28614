"""Weights from the reference's parameter tree into the port's layout.

This is the one place where layouts change: the reference keeps projections
as (in, out) matrices stacked on a leading layer axis; the port keeps one
dict per layer with (out, in) matrices for ``F.linear``.  Mamba2 blocks
carry ``in_proj``/``out_proj`` transposed and their other tensors as they
are.
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
_SSM_LINEAR = ("in_proj", "out_proj")
_SSM_AS_IS = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")


def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device, dtype: torch.dtype) -> Params:
    """``np_params``: the reference's tree as numpy arrays — ``embed``
    (V, D), ``blocks`` stacked on a leading L axis (dense:
    ``{ln1, ln2, attn.{wq,wk,wv,wo}, mlp.{wg,wu,wd}}``; ssm/hybrid:
    ``{ln1, ssm.{...}}``), the hybrid's unstacked ``shared`` block,
    ``final_norm`` (D,) and, untied, ``head`` (D, V).  Returns the port's
    params on ``device`` in ``dtype``."""
    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def linear(a: np.ndarray) -> torch.Tensor:
        return t(np.swapaxes(a, -1, -2))        # (in, out) -> (out, in)

    def attn_mlp(tree: Mapping[str, Any], pick) -> Params:
        attn = {name: linear(pick(tree["attn"][name])) for name in _ATTN}
        attn.update({name: t(pick(tree["attn"][name])) for name in _BIAS
                     if name in tree["attn"]})
        return {"ln1": t(pick(tree["ln1"])), "attn": attn,
                "ln2": t(pick(tree["ln2"])),
                "mlp": {name: linear(pick(tree["mlp"][name]))
                        for name in _MLP}}

    blocks = np_params["blocks"]
    out: Params = {"embed": t(np_params["embed"]), "blocks": []}
    for i in range(cfg.num_layers):
        if "ssm" in blocks:
            ssm = {name: linear(blocks["ssm"][name][i]) for name in _SSM_LINEAR}
            ssm.update({name: t(blocks["ssm"][name][i]) for name in _SSM_AS_IS})
            out["blocks"].append({"ln1": t(blocks["ln1"][i]), "ssm": ssm})
        else:
            out["blocks"].append(attn_mlp(blocks, lambda a: a[i]))
    if "shared" in np_params:
        out["shared"] = attn_mlp(np_params["shared"], lambda a: a)
    out["final_norm"] = t(np_params["final_norm"])
    if "head" in np_params:
        out["head"] = linear(np_params["head"])
    return out
