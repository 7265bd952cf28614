"""The port's decoder params (``models/transformer.py``'s hybrid_moe
family) from ``perfbench/reference/hybrid_moe.py``'s leaves: the same
tensors, no copy, once the correction bias is learned in place
(``reference.hybrid_moe.learn_bias``), as a checkpoint's would be."""

import time
from typing import Dict

from ..reference.hybrid_moe import learn_bias

#: the seconds the last :func:`port_params` spent learning the bias (part
#: of the run's set-up)
learn_s = 0.0

_SSM = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
        "out_proj")


def port_params(w: Dict, s: Dict) -> Dict:
    global learn_s
    t0 = time.perf_counter()
    learn_bias(w, s)
    learn_s = time.perf_counter() - t0
    blocks = []
    for i, kind in enumerate(s["layer_pattern"]):
        p = f"layers.{i}."
        b = {"ln1": w[p + "ln1"]}
        if kind == "M":
            b["ssm"] = {n: w[p + n] for n in _SSM}
        elif kind == "E":
            b["moe"] = {"router": w[p + "router"], "bias": w[p + "bias"],
                        "wu": w[p + "wu"], "wd": w[p + "wd"],
                        "shared": {"wu": w[p + "shared_wu"],
                                   "wd": w[p + "shared_wd"]}}
        else:
            b["attn"] = {n: w[p + n] for n in ("wq", "wk", "wv", "wo")}
        blocks.append(b)
    return {"embed": w["embed"], "blocks": blocks,
            "final_norm": w["final_norm"], "head": w["head"]}
