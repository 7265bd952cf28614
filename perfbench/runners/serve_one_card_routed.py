"""``serve_one_card`` for a model whose MoE layers record their choice of
experts in the cache (``route``, the ``hybrid_moe`` family): the same run,
with each finished request's served routes kept for the comparison that
decides ``correct``.

At each finish (``ServeEngine.on_finish``, while the slot's cache still
holds the sequence) the slot's routes over the request's positions, its
prompt and its served tokens but the last, are copied on the device into
``weights[ROUTES]`` (``reference/hybrid_moe.py``'s ``RouteBook``) under
the token ids.  The reference then follows the program's expert choices
where they are ones it could make itself (``reference/hybrid_moe.py``), so
that bf16 near-ties, which part a random-weight MoE from the float32 model
as far as float8 does, do not decide the comparison.  The book's widest
slack and the positions refused are the run's notes ``route_slack`` and
``route_refused``; ``learn_bias_s`` is the set-up's seconds learning the
router's correction bias (``layouts/hybrid_moe.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from perfbench import bench
from perfbench.layouts import hybrid_moe as layout
from perfbench.reference.hybrid_moe import ROUTES, RouteBook
from perfbench.runners import serve_one_card as base


def keep_routes(sys_: base.System) -> RouteBook:
    """Register the copy of each finished request's routes; returns the
    book (also ``sys_.weights[ROUTES]``)."""
    eng = sys_.engine
    book = sys_.weights[ROUTES] = RouteBook()

    def finished(req, slot: int) -> None:
        n = int(eng.slot_pos[slot])
        seq = np.concatenate([req.prompt, np.asarray(req.output[:-1],
                                                     np.int64)])
        book[tuple(int(t) for t in seq[:n])] = \
            eng.cache["route"][:, slot, :n].clone()
    eng.on_finish.append(finished)
    return book


def run(cell: bench.Cell, *, seed: int, seconds: float, trace: bool,
        device="cuda", started: Optional[float] = None, cfg=None,
        control: bool = False, fault=None) -> bench.Outcome:
    """``serve_one_card.run`` with the served routes kept (``fault``, the
    tests' break of the system, after the routes' hook)."""
    books = []

    def setup(sys_):
        books.append(keep_routes(sys_))
        if fault is not None:
            fault(sys_)
    out = base.run(cell, seed=seed, seconds=seconds, trace=trace,
                   device=device, started=started, cfg=cfg, control=control,
                   fault=setup)
    out.notes["route_slack"] = books[0].slack
    out.notes["route_refused"] = books[0].refused
    out.notes["learn_bias_s"] = layout.learn_s
    return out
