"""Weights from the reference's parameter tree into the port's layout.

This is the one place where layouts change: the reference keeps projections
as (in, out) matrices stacked on a leading layer axis; the port keeps one
dict per layer with (out, in) matrices for ``F.linear``.  Mamba2 blocks
carry ``in_proj``/``out_proj`` transposed and their other tensors as they
are.  MoE experts stay in the reference's (E, in, out) layout, the one
``models/moe.py``'s ``torch.bmm`` reads without a copy; their router and
shared SwiGLU are transposed like any projection.  Biases, norm gains,
LayerNorm ``scale``/``bias`` and the learned ``pos_embed`` are as they are.

Under a mesh, :func:`params_from_jax` returns one rank's shard: each leaf
is cut in numpy to the rank's ``distributed/sharding.py`` ``local_index``
before it is converted, so a rank never holds another rank's part.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed.mesh import Mesh
from ..distributed.sharding import local_index, take, transposed

Params = Dict[str, Any]

_ATTN = ("wq", "wk", "wv", "wo")
_BIAS = ("bq", "bk", "bv")
_MLP = ("wg", "wu", "wd")
_GELU_LINEAR = ("w1", "w2")
_GELU_BIAS = ("b1", "b2")
_SSM_LINEAR = ("in_proj", "out_proj")
_SSM_AS_IS = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")


def reference_last_axis(path: str, leaf: torch.Tensor) -> int:
    """The axis of the port's ``leaf`` (at ``path``, its keys joined by
    ``/``) that is the last axis of the reference's: 0 for a projection
    stored transposed as (out, in), -1 for every leaf kept as it is (the
    embedding, the position table, conv weights, expert stacks, vectors)."""
    return 0 if transposed(path, leaf.ndim) else -1


def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device, dtype: torch.dtype,
                    mesh: Optional[Mesh] = None,
                    coords: Optional[Dict[str, int]] = None,
                    batch_axes: Sequence[str] = ()) -> Params:
    """``np_params``: the reference's tree as numpy arrays.  The decoder's:
    ``embed`` (V, D), ``blocks`` stacked on a leading L axis (dense, vlm:
    ``{ln1, ln2, attn.{wq,wk,wv,wo[,bq,bk,bv]}, mlp.{wg,wu,wd}}``; moe:
    ``moe.{router (D, E), wg/wu (E, D, F), wd (E, F, D)[, shared]}`` in
    place of ``mlp``; ssm/hybrid: ``{ln1, ssm.{...}}``), the hybrid's
    unstacked ``shared`` block, ``final_norm`` (D,) and, untied, ``head``
    (D, V).  The encoder-decoder's (``cfg.family == "audio"``): ``embed``,
    ``pos_embed``, ``enc_blocks`` and ``dec_blocks`` stacked, ``enc_norm``,
    ``dec_norm``.  Returns the port's params on ``device`` in ``dtype``:
    under ``mesh``, the shard of the rank at ``coords`` (default: the
    mesh's own rank); with ``batch_axes``, training's layout (also split
    over them)."""
    def t(a: np.ndarray) -> np.ndarray:
        return np.asarray(a)

    def linear(a: np.ndarray) -> np.ndarray:
        return np.swapaxes(a, -1, -2)           # (in, out) -> (out, in)

    def place(path: str, a: np.ndarray) -> torch.Tensor:
        a = take(a, local_index(cfg, mesh, path, a.shape, coords,
                                batch_axes=batch_axes))
        # through fp32, which holds bf16 and int8 values exactly
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def walk(tree, prefix: str):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
        return place(prefix, tree)

    return walk(_port_tree(np_params, cfg, t, linear), "")


def _port_tree(np_params: Mapping[str, Any], cfg: ModelConfig, t,
               linear) -> Params:
    """The reference's tree in the port's structure and layout (numpy
    views, not yet converted)."""

    Pick = Callable[[np.ndarray], np.ndarray]

    def attn(tree: Mapping[str, Any], pick: Pick) -> Params:
        p = {name: linear(pick(tree[name])) for name in _ATTN}
        p.update({name: t(pick(tree[name])) for name in _BIAS
                  if name in tree})
        return p

    def swiglu(tree: Mapping[str, Any], pick: Pick) -> Params:
        return {name: linear(pick(tree[name])) for name in _MLP}

    def ffn(tree: Mapping[str, Any], pick: Pick) -> Params:
        if "mlp" in tree:
            return {"mlp": swiglu(tree["mlp"], pick)}
        moe = tree["moe"]
        p = {"router": linear(pick(moe["router"]))}
        p.update({name: t(pick(moe[name])) for name in _MLP})
        if "shared" in moe:
            p["shared"] = swiglu(moe["shared"], pick)
        return {"moe": p}

    def attn_ffn(tree: Mapping[str, Any], pick: Pick) -> Params:
        return {"ln1": t(pick(tree["ln1"])), "attn": attn(tree["attn"], pick),
                "ln2": t(pick(tree["ln2"])), **ffn(tree, pick)}

    def ln(tree: Mapping[str, Any], pick: Pick) -> Params:
        return {"scale": t(pick(tree["scale"])), "bias": t(pick(tree["bias"]))}

    def encdec_layer(tree: Mapping[str, Any], pick: Pick) -> Params:
        p: Params = {}
        for name, sub in tree.items():
            if name.startswith("ln"):               # ln1, ln_x, ln2
                p[name] = ln(sub, pick)
            elif name == "mlp":
                p[name] = {n: linear(pick(sub[n])) for n in _GELU_LINEAR}
                p[name].update({n: t(pick(sub[n])) for n in _GELU_BIAS})
            else:                                   # attn, self_attn, cross_attn
                p[name] = attn(sub, pick)
        return p

    if cfg.family == "audio":
        enc, dec = np_params["enc_blocks"], np_params["dec_blocks"]
        return {
            "embed": t(np_params["embed"]),
            "pos_embed": t(np_params["pos_embed"]),
            "enc_blocks": [encdec_layer(enc, lambda a, i=i: a[i])
                           for i in range(cfg.encoder_layers)],
            "enc_norm": ln(np_params["enc_norm"], lambda a: a),
            "dec_blocks": [encdec_layer(dec, lambda a, i=i: a[i])
                           for i in range(cfg.num_layers)],
            "dec_norm": ln(np_params["dec_norm"], lambda a: a)}

    blocks = np_params["blocks"]
    out: Params = {"embed": t(np_params["embed"]), "blocks": []}
    for i in range(cfg.num_layers):
        if "ssm" in blocks:
            ssm = {name: linear(blocks["ssm"][name][i]) for name in _SSM_LINEAR}
            ssm.update({name: t(blocks["ssm"][name][i]) for name in _SSM_AS_IS})
            out["blocks"].append({"ln1": t(blocks["ln1"][i]), "ssm": ssm})
        else:
            out["blocks"].append(attn_ffn(blocks, lambda a: a[i]))
    if "shared" in np_params:
        out["shared"] = attn_ffn(np_params["shared"], lambda a: a)
    out["final_norm"] = t(np_params["final_norm"])
    if "head" in np_params:
        out["head"] = linear(np_params["head"])
    return out

