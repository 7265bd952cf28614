"""The port's decoder params (``models/transformer.py``, ``ssm.py``) of a
Mamba2 model from ``perfbench/reference/ssm.py``'s leaves."""

from typing import Dict

_SSM = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
        "out_proj")


def port_params(w: Dict, s: Dict) -> Dict:
    blocks = [{"ln1": w[f"layers.{i}.ln1"],
               "ssm": {n: w[f"layers.{i}.{n}"] for n in _SSM}}
              for i in range(s["num_layers"])]
    out = {"embed": w["embed"], "blocks": blocks,
           "final_norm": w["final_norm"]}
    if not s["tie_embeddings"]:
        out["head"] = w["head"]
    return out
