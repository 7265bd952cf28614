"""The one traffic generator: a mix file's parameters and a seed in,
requests out.

Every seed gets the same schedule: the lengths of a mix's requests are
the distribution's quantiles at ``(i + 0.5) / n`` and the open loop's
gaps between arrivals the exponential's, each list shuffled by one fixed
stream (a replayed schedule; the seed draws the token ids, and the
runner the weights).  At four fifths of the knee the order alone moves
the tail of the time to first token by a factor of five, far more than
two runs of one order differ, so the order is not the seed's to draw.

A mix (``perfbench/traffic/<name>.json``) holds:

* ``loop``: ``"open"`` (requests due on a schedule, whatever the system
  does; ``rate_per_s`` Poisson arrivals) or ``"closed"``
  (``clients_per_slot`` clients per engine slot, each sending its next
  request when its last one finishes);
* ``prompt`` and ``output``: the lengths' distributions, each
  ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
  ``{"dist": "uniform", "min", "max"}`` (integers, both ends included);
* ``pool_per_client`` (closed loop): how many requests the lists hold
  for each client; a closed loop cycles through them, each time with new
  token ids.  An open loop holds ``floor(rate_per_s * seconds)``
  requests, all due inside the window, so every seed offers the same
  set at the same rate;
* what the runner and the readers take from it (``trace_steps``,
  ``sample_tokens``, ``stagger``).

A cell's own file (``perfbench/cells/<cell>.json``) may set any of these
keys over the mix's, as the offered rate of an open loop.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


def seed_words(seed: int, *tags: int) -> List[int]:
    """Entropy words for numpy's ``SeedSequence`` from any whole number
    (negative or past 64 bits too) and ``tags``."""
    words = [1 if seed < 0 else 0]
    s = abs(int(seed))
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return words + [int(t) for t in tags]


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed_words(seed, *tags)))


def lengths(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the distribution's quantiles ``(i + 0.5) / n``,
    ascending, clipped to ``[min, max]``."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(p)) for p in u])
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        x = spec["min"] + u * (spec["max"] + 1 - spec["min"]) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass
class Request:
    """One request of a run: its place in the pool, its lengths and, in an
    open loop, when it falls due (seconds after the window opens)."""
    index: int
    prompt_len: int
    max_new: int
    due: float = 0.0


@dataclasses.dataclass
class Traffic:
    mix: Dict
    seed: int
    vocab: int
    requests: List[Request]

    def request(self, j: int) -> Request:
        """The ``j``-th request sent: a closed loop cycles through the
        pool's sizes."""
        base = self.requests[j % len(self.requests)]
        return dataclasses.replace(base, index=j)

    def prompt(self, req: Request) -> np.ndarray:
        """The token ids of ``req``'s prompt, uniform over the vocabulary,
        drawn from the seed and the request's place."""
        return rng(self.seed, 1, req.index).integers(
            0, self.vocab, req.prompt_len, dtype=np.int64).astype(np.int32)


def pool_size(mix: Dict, seconds: float, slots: int) -> int:
    """How many requests the lists hold (module docstring)."""
    if mix["loop"] == "open":
        return max(2, int(math.floor(float(mix["rate_per_s"]) * seconds)))
    return clients(mix, slots) * int(mix["pool_per_client"])


def clients(mix: Dict, slots: int) -> int:
    return int(mix["clients_per_slot"]) * slots


def generate(mix: Dict, seed: int, vocab: int, n: int) -> Traffic:
    """The run's ``n`` requests in the order they are sent.  An open
    loop's first request falls due as the window opens (``due`` 0), the
    rest at the exponential's quantile gaps, shuffled and scaled so that
    the ``n`` fall due at ``n`` per ``n / rate_per_s`` seconds."""
    r = rng(0, 0)
    prompts = r.permutation(lengths(mix["prompt"], n))
    outputs = r.permutation(lengths(mix["output"], n))
    reqs = [Request(i, int(p), int(o)) for i, (p, o)
            in enumerate(zip(prompts, outputs))]
    if mix["loop"] == "open":
        gaps = -np.log1p(-(np.arange(n - 1) + 0.5) / (n - 1))
        gaps *= (n - 1) / float(mix["rate_per_s"]) / gaps.sum()
        due = np.concatenate([[0.0], np.cumsum(r.permutation(gaps))])
        for req, t in zip(reqs, due):
            req.due = float(t)
    elif mix["loop"] != "closed":
        raise ValueError(f"loop is open or closed, not {mix['loop']!r}")
    return Traffic(mix, seed, vocab, reqs)
