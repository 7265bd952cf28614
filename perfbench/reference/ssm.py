"""A Mamba2 (SSD) decoder in plain float32 (mamba2-370m's family): in
each layer an RMS norm, the input projection into ``z | x | B | C | dt``,
a causal depthwise convolution over ``x | B | C`` and SiLU, the
selective state-space recurrence with one group of ``B``, ``C`` shared
by every head, the skip ``D * x``, a gated RMS norm (norm, then times
``silu(z)``) and the output projection; a final RMS norm and the tied
embedding as the head.

The recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
``y_t = C_t . h_t`` from a zero state is computed in its quadratic
form over the whole sequence (``y_t = sum_{s <= t} (C_t . B_s)
exp(sum_{s < r <= t} dt_r A) dt_s x_s``), block of rows by block, with
the decays' running sums in float64.  Departures from the published
model are the configuration file's (``departures``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .common import exact_fp32, head, linear, rms_norm

#: rows of one block of the quadratic form
T_BLOCK = 512


def dims(s: Dict) -> Dict[str, int]:
    d_in = s["ssm_expand"] * s["d_model"]
    return dict(d_in=d_in, H=d_in // s["ssm_head_dim"], P=s["ssm_head_dim"],
                N=s["ssm_state"], W=s["ssm_conv_width"],
                d_conv=d_in + 2 * s["ssm_state"])


def weight_spec(s: Dict) -> list:
    D, V = s["d_model"], s["vocab_size"]
    d = dims(s)
    spec = [("embed", (V, D), ("std", 0.02))]
    for i in range(s["num_layers"]):
        p = f"layers.{i}."
        spec += [(p + "ln1", (D,), ("gain", 0.1)),
                 (p + "in_proj", (2 * d["d_in"] + 2 * d["N"] + d["H"], D),
                  ("fan_in", 1)),
                 (p + "conv_w", (d["W"], d["d_conv"]), ("fan_in", 0)),
                 (p + "conv_b", (d["d_conv"],), ("std", 0.1)),
                 (p + "A_log", (d["H"],), ("a_log",)),
                 (p + "D", (d["H"],), ("one_plus", 0.1)),
                 (p + "dt_bias", (d["H"],), ("dt_bias",)),
                 (p + "norm", (d["d_in"],), ("gain", 0.1)),
                 (p + "out_proj", (D, d["d_in"]), ("fan_in", 1))]
    spec.append(("final_norm", (D,), ("gain", 0.1)))
    if not s["tie_embeddings"]:
        spec.append(("head", (V, D), ("fan_in", 1)))
    return spec


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal convolution of (S, C) with taps (W, C): output
    ``s`` is ``sum_j u[s - W + 1 + j] w[j] + b``, zeros before the start."""
    W = w.shape[0]
    up = F.pad(u, (0, 0, W - 1, 0))
    S = u.shape[0]
    return sum(up[j:j + S] * w[j].float() for j in range(W)) + b.float()


def scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """y (S, H, P) of the recurrence from a zero state; x (S, H, P),
    dt (S, H), A (H,), B/C (S, N)."""
    S = x.shape[0]
    cum = torch.cumsum(dt.double() * A.double(), dim=0)        # (S, H)
    xdt = (x * dt[..., None]).transpose(0, 1)                  # (H, S, P)
    y = torch.empty_like(x)
    for a in range(0, S, T_BLOCK):
        b = min(S, a + T_BLOCK)
        seg = cum[a:b, None, :] - cum[None, :b, :]             # (t, s, H)
        later = (torch.arange(b, device=x.device)[None, :]
                 > torch.arange(a, b, device=x.device)[:, None])
        decay = torch.where(later[..., None], 0.0, torch.exp(seg)).float()
        mix = (C[a:b] @ B[:b].T)[..., None] * decay           # (t, s, H)
        y[a:b] = (mix.permute(2, 0, 1) @ xdt[:, :b]).transpose(0, 1)
    return y


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], s: Dict,
           tokens: torch.Tensor, positions: Sequence[int],
           quant: Optional[str] = None) -> torch.Tensor:
    """float32 logits (len(positions), V) of the sequence ``tokens``
    (S,) at ``positions``; ``quant="fp8"`` is the control's precision."""
    d = dims(s)
    d_in, H, P, N = d["d_in"], d["H"], d["P"], d["N"]
    eps = s["norm_eps"]
    with exact_fp32():
        x = weights["embed"][tokens].float()
        S = x.shape[0]
        for i in range(s["num_layers"]):
            w = {n: weights[f"layers.{i}.{n}"] for n in
                 ("ln1", "in_proj", "conv_w", "conv_b", "A_log", "D",
                  "dt_bias", "norm", "out_proj")}
            proj = linear(rms_norm(x, w["ln1"], eps), w["in_proj"], quant)
            z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)
            xbc = F.silu(causal_conv(xbc, w["conv_w"], w["conv_b"]))
            xin, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
            xh = xin.reshape(S, H, P)
            A = -torch.exp(w["A_log"].float())
            dt = F.softplus(dt + w["dt_bias"].float())
            y = scan(xh, dt, A, Bm, Cm) + xh * w["D"].float()[:, None]
            y = rms_norm(y.reshape(S, d_in), w["norm"], eps) * F.silu(z)
            x = x + linear(y, w["out_proj"], quant)
        return head(x[list(positions)], weights, s, quant)
