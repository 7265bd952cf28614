"""A Nemotron-H decoder in plain float32 (nemotron-3-nano-30b-a3b's
family, ``hybrid_moe``): a pattern of layers, each ``x + mixer(rms_norm
(x))``, the mixer by the layer's letter:

* M, Mamba2: the input projection into ``z | x | B | C | dt``, a causal
  depthwise convolution with bias over ``x | B | C`` and SiLU, B and C in
  G groups (head h reads group h // (H / G)), the state-space recurrence
  block by block (``reference/ssm.py``'s ``scan``, once per group over its
  heads), the skip ``D * x``, then the gate first, ``y * silu(z)``, an
  RMS norm over each group of d_inner / G channels and the output
  projection;
* E, sparse MoE: fp32 router logits, sigmoid scores s; the top-k of s +
  the correction bias choose the experts, s of the chosen, renormalised
  and times the routed scale, weigh them; each chosen expert
  ``wd relu(wu x)^2`` over its tokens, every routed expert applied, no
  capacity; plus the shared expert of its own width;
* *, attention: grouped-query causal softmax at 1/sqrt(head_dim), no
  rotary embedding.

A final RMS norm and the untied head.  The norms' gains are ``1 + w``
(``common.rms_norm``), as every family here draws them.  Departures from
the published model are the configuration file's (``departures``).

Served routes.  Near-tied experts make the comparison chaotic: a
rounding that swaps a 6th and 7th expert, which bf16 does in some
positions of every layer, moves the residual, and over 23 MoE layers with
random weights the program and the float32 model part as far as a float8
one does.  So where the run kept the program's own choice of experts for
a sequence (``weights[ROUTES]``: the token ids -> (MoE layers, positions,
k), ``runners/serve_one_card_routed.py``), this reference takes it in
place of its own top-k, position by position, where the choice is one it
could make itself: k distinct experts, each with a biased score no more
than ``ROUTE_TOL`` below its own k-th best.  Elsewhere it keeps its own
choice, so that a router that picks other experts parts the two.  The
weights of the chosen experts are always its own float32 scores.  The
widest slack of a served choice of k distinct experts is kept beside the
routes (``RouteBook.slack``), and the positions it refused
(``RouteBook.refused``).

The correction bias is a learned vector: a trained model's keeps its
experts' load even (the auxiliary-loss-free rule: raise the bias of an
expert that gets less than its share of the rows, lower it above).
:func:`learn_bias` learns it so on the drawn weights, layer by layer
through this forward over a fixed calibration sequence, before the
weights go to the program (``layouts/hybrid_moe.py``).  Without it the
random router sends the rows of a 64-token decode step to three quarters
of the experts, where a balanced one reaches 95%.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .common import exact_fp32, head, linear, rms_norm
from .dense import attention
from .ssm import causal_conv, scan

#: the key under which ``weights`` may hold a run's served routes
ROUTES = "served_routes"
#: how far (in sigmoid score) below the reference's own k-th best biased
#: score a served expert may lie and still be followed
ROUTE_TOL = 0.05


class RouteBook(dict):
    """The served routes of a run's finished requests: the token ids
    (prompt and served tokens but the last) -> (MoE layers, positions, k)
    expert ids; ``slack``: the widest gap below the k-th best of a served
    choice of k distinct experts, ``refused``: (positions, layers) not
    followed."""

    def __init__(self):
        super().__init__()
        self.slack = 0.0
        self.refused = 0


#: the correction bias's starting spread (a normal times this), from
#: which :func:`learn_bias` learns it
BIAS_STD = 0.05
#: the calibration sequence's length, the balancing rule's steps and its
#: first step size (falling linearly to 0)
CALIB_TOKENS = 512
BALANCE_STEPS = 300
BALANCE_RATE = 0.02


def dims(s: Dict) -> Dict[str, int]:
    H, P, G, N = s["ssm_heads"], s["ssm_head_dim"], s["ssm_groups"], \
        s["ssm_state"]
    d_in = H * P
    return dict(d_in=d_in, H=H, P=P, N=N, G=G, W=s["ssm_conv_width"],
                d_conv=d_in + 2 * G * N)


def weight_spec(s: Dict) -> list:
    D, V = s["d_model"], s["vocab_size"]
    d = dims(s)
    Hq, K, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    E, Fe, Fs = s["num_experts"], s["d_ff"], s["shared_d_ff"]
    spec = [("embed", (V, D), ("std", 0.02))]
    for i, kind in enumerate(s["layer_pattern"]):
        p = f"layers.{i}."
        spec.append((p + "ln1", (D,), ("gain", 0.1)))
        if kind == "M":
            spec += [(p + "in_proj", (2 * d["d_in"] + 2 * d["G"] * d["N"]
                                      + d["H"], D), ("fan_in", 1)),
                     (p + "conv_w", (d["W"], d["d_conv"]), ("fan_in", 0)),
                     (p + "conv_b", (d["d_conv"],), ("std", 0.1)),
                     (p + "A_log", (d["H"],), ("a_log",)),
                     (p + "D", (d["H"],), ("one_plus", 0.1)),
                     (p + "dt_bias", (d["H"],), ("dt_bias",)),
                     (p + "norm", (d["d_in"],), ("gain", 0.1)),
                     (p + "out_proj", (D, d["d_in"]), ("fan_in", 1))]
        elif kind == "E":
            # the expert stacks in the program's (in, out) layout
            spec += [(p + "router", (E, D), ("fan_in", 1)),
                     (p + "bias", (E,), ("std", BIAS_STD)),
                     (p + "wu", (E, D, Fe), ("fan_in", 1)),
                     (p + "wd", (E, Fe, D), ("fan_in", 1)),
                     (p + "shared_wu", (Fs, D), ("fan_in", 1)),
                     (p + "shared_wd", (D, Fs), ("fan_in", 1))]
        else:
            spec += [(p + "wq", (Hq * hd, D), ("fan_in", 1)),
                     (p + "wk", (K * hd, D), ("fan_in", 1)),
                     (p + "wv", (K * hd, D), ("fan_in", 1)),
                     (p + "wo", (D, Hq * hd), ("fan_in", 1))]
    spec.append(("final_norm", (D,), ("gain", 0.1)))
    spec.append(("head", (V, D), ("fan_in", 1)))
    return spec


def mamba(w: Dict, s: Dict, h: torch.Tensor, quant: Optional[str]
          ) -> torch.Tensor:
    d = dims(s)
    d_in, H, P, N, G = d["d_in"], d["H"], d["P"], d["N"], d["G"]
    S = h.shape[0]
    proj = linear(h, w["in_proj"], quant)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * G * N, H], dim=-1)
    xbc = F.silu(causal_conv(xbc, w["conv_w"], w["conv_b"]))
    xin, Bm, Cm = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    xh = xin.reshape(S, H, P)
    Bm, Cm = Bm.reshape(S, G, N), Cm.reshape(S, G, N)
    A = -torch.exp(w["A_log"].float())
    dt = F.softplus(dt + w["dt_bias"].float())
    Hg = H // G
    y = torch.cat([scan(xh[:, g * Hg:(g + 1) * Hg], dt[:, g * Hg:(g + 1) * Hg],
                        A[g * Hg:(g + 1) * Hg], Bm[:, g], Cm[:, g])
                   for g in range(G)], dim=1)
    y = (y + xh * w["D"].float()[:, None]).reshape(S, d_in) * F.silu(z)
    y = y.reshape(S, G, d_in // G)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + s["norm_eps"])
    y = y.reshape(S, d_in) * (1.0 + w["norm"].float())
    return linear(y, w["out_proj"], quant)


def served_choice(biased: torch.Tensor, own: torch.Tensor,
                  served: torch.Tensor, book: RouteBook) -> torch.Tensor:
    """Per position, the served experts where they are k distinct ones
    each within ``ROUTE_TOL`` of the k-th best of ``biased``, else
    ``own``."""
    served = served.long()
    slack = biased.gather(1, own[:, -1:]) - biased.gather(1, served)
    s_sorted = served.sort(dim=-1).values
    distinct = (s_sorted[:, 1:] != s_sorted[:, :-1]).all(-1)
    ok = distinct & (slack.amax(-1) <= ROUTE_TOL)
    if bool(distinct.any()):
        book.slack = max(book.slack, float(slack[distinct].max()))
    book.refused += int((~ok).sum())
    return torch.where(ok[:, None], served, own)


def moe(w: Dict, s: Dict, h: torch.Tensor, quant: Optional[str],
        served: Optional[torch.Tensor] = None,
        book: Optional[RouteBook] = None) -> torch.Tensor:
    """``served`` (positions, k): the program's choice, followed as
    :func:`served_choice` says."""
    k = s["experts_per_token"]
    scores = torch.sigmoid(linear(h, w["router"], quant))
    biased = scores + w["bias"].float()
    ids = torch.topk(biased, k, dim=-1).indices
    if served is not None:
        ids = served_choice(biased, ids, served, book)
    wt = scores.gather(1, ids)
    wt = wt / (wt.sum(-1, keepdim=True) + 1e-20) * s["routed_scale"]
    out = linear(torch.relu(linear(h, w["shared_wu"], quant)).square(),
                 w["shared_wd"], quant)
    for e in ids.unique().tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        u = torch.relu(linear(h[tok], w["wu"][e].T, quant)).square()
        out.index_add_(0, tok, linear(u, w["wd"][e].T, quant)
                       * wt[tok, slot, None])
    return out


def attn(w: Dict, s: Dict, h: torch.Tensor, quant: Optional[str]
         ) -> torch.Tensor:
    Hq, K, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    S = h.shape[0]
    q = linear(h, w["wq"], quant).view(S, Hq, hd)
    k = linear(h, w["wk"], quant).view(S, K, hd)
    v = linear(h, w["wv"], quant).view(S, K, hd)
    return linear(attention(q, k, v).reshape(S, Hq * hd), w["wo"], quant)


MIXERS = {"M": mamba, "E": moe, "*": attn}


def _layer(weights: Dict[str, torch.Tensor], i: int) -> Dict:
    p = f"layers.{i}."
    return {n[len(p):]: t for n, t in weights.items() if n.startswith(p)}


@torch.no_grad()
def learn_bias(weights: Dict[str, torch.Tensor], s: Dict) -> None:
    """Set every MoE layer's ``bias`` in place to balance its experts'
    load over a calibration sequence of ``CALIB_TOKENS`` token ids (a
    fixed generator's): from the drawn bias, ``BALANCE_STEPS`` steps of
    ``bias += rate * sign(share - load)``, the rate falling to 0, on the
    layer's router scores; then the layer runs with it, and the next."""
    dev = weights["embed"].device
    tokens = torch.randint(0, s["vocab_size"], (CALIB_TOKENS,),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    k, E = s["experts_per_token"], s["num_experts"]
    share = CALIB_TOKENS * k / E
    with exact_fp32():
        x = weights["embed"][tokens].float()
        for i, kind in enumerate(s["layer_pattern"]):
            w = _layer(weights, i)
            h = rms_norm(x, w["ln1"], s["norm_eps"])
            if kind == "E":
                scores = torch.sigmoid(linear(h, w["router"]))
                bias = w["bias"].float()
                for step in range(BALANCE_STEPS):
                    ids = torch.topk(scores + bias, k, dim=-1).indices
                    load = torch.bincount(ids.reshape(-1), minlength=E)
                    bias += BALANCE_RATE * (1 - step / BALANCE_STEPS) \
                        * torch.sign(share - load)
                w["bias"].copy_(bias)
            x = x + MIXERS[kind](w, s, h, None)


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], s: Dict,
           tokens: torch.Tensor, positions: Sequence[int],
           quant: Optional[str] = None) -> torch.Tensor:
    """float32 logits (len(positions), V) of the sequence ``tokens``
    (S,) at ``positions``, with the served routes where ``weights[ROUTES]``
    holds the sequence's; ``quant="fp8"`` is the control's precision."""
    if s["use_rope"]:
        raise ValueError("this reference applies no rotary embedding")
    book = weights.get(ROUTES)
    routes = None if book is None else book.get(tuple(tokens.tolist()))
    with exact_fp32():
        x = weights["embed"][tokens].float()
        e = 0
        for i, kind in enumerate(s["layer_pattern"]):
            w = _layer(weights, i)
            h = rms_norm(x, w["ln1"], s["norm_eps"])
            if kind == "E":
                served = None if routes is None else routes[e].to(x.device)
                x = x + moe(w, s, h, quant, served, book)
                e += 1
            else:
                x = x + MIXERS[kind](w, s, h, quant)
        return head(x[list(positions)], weights, s, quant)
