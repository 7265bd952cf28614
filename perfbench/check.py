"""How ``correct`` is decided for a served model.

Once the window has closed, a sample of the finished requests, drawn from
the seed and holding the longest (prompt and output together), is run
through the family's plain float32 reference over each prompt with its
served tokens.  At each position that produced a served token the
reference's best logit and the served token's are compared; the number
judged is the widest gap by which a served token lies below the
reference's best (``logit_gap``; 0 where every token is the reference's
argmax).  The serving engine decodes greedily, so the gap is valid for
every token.

The control (:func:`control_gap`, run by ``perfbench/control.py`` and the
tests, never by a run) puts the reference itself in the program's place in
the precision below the configuration's bfloat16: every projection in
float8 e4m3; it reads the gap of the token that this reference puts
first at each position of the same prompts and tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import traffic


@dataclasses.dataclass
class Served:
    """A finished request: its prompt and the tokens the engine served."""
    prompt: np.ndarray
    output: List[int]

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.output)


def sample(finished: Sequence[Served], seed: int, tokens: int
           ) -> List[Served]:
    """The longest request, then others in an order drawn from the seed,
    until the sample holds ``tokens`` served tokens or every request."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: -finished[i].length)
    rest = list(traffic.rng(seed, 2).permutation(order[1:]))
    out = [finished[order[0]]]
    for i in rest:
        if sum(len(r.output) for r in out) >= tokens:
            break
        out.append(finished[int(i)])
    return out


def _inputs(req: Served, device) -> tuple:
    seq = np.concatenate([req.prompt, np.asarray(req.output[:-1], np.int64)])
    P = len(req.prompt)
    positions = list(range(P - 1, P - 1 + len(req.output)))
    return torch.as_tensor(seq, dtype=torch.long, device=device), positions


def _gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    best = ref.max(dim=-1).values
    return float((best - ref.gather(1, chosen[:, None])[:, 0]).max())


def logit_gap(reference, weights: Dict, sizes: Dict,
              reqs: Sequence[Served], device) -> Optional[float]:
    """The widest gap below the reference's best of a served token."""
    worst = None
    for req in reqs:
        seq, pos = _inputs(req, device)
        ref = reference.logits(weights, sizes, seq, pos)
        served = torch.as_tensor(req.output, dtype=torch.long, device=device)
        g = _gap(ref, served)
        worst = g if worst is None else max(worst, g)
    return worst


def control_gap(reference, weights: Dict, sizes: Dict,
                reqs: Sequence[Served], device) -> Optional[float]:
    """The widest gap below the reference's best of the token that the
    float8 reference puts first, at the same positions."""
    worst = None
    for req in reqs:
        seq, pos = _inputs(req, device)
        ref = reference.logits(weights, sizes, seq, pos)
        low = reference.logits(weights, sizes, seq, pos, quant="fp8")
        g = _gap(ref, low.argmax(dim=-1))
        worst = g if worst is None else max(worst, g)
    return worst
