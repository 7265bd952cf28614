"""The port's decoder params (``models/transformer.py``) of a dense
model from ``perfbench/reference/dense.py``'s leaves."""

from typing import Dict


def port_params(w: Dict, s: Dict) -> Dict:
    blocks = []
    for i in range(s["num_layers"]):
        p = f"layers.{i}."
        blocks.append({
            "ln1": w[p + "ln1"], "ln2": w[p + "ln2"],
            "attn": {n: w[p + n] for n in ("wq", "wk", "wv", "wo")},
            "mlp": {n: w[p + n] for n in ("wg", "wu", "wd")}})
    out = {"embed": w["embed"], "blocks": blocks,
           "final_norm": w["final_norm"]}
    if not s["tie_embeddings"]:
        out["head"] = w["head"]
    return out
