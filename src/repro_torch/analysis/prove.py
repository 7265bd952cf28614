"""Static rate-stability prover (interval arithmetic over the §6 recurrence).

Decides — *without running the simulator* — whether an allocation/schedule
sustains a DAG input rate, by propagating rate intervals along the DAG
edges and comparing them against per-group capacity bounds:

* task rates follow the paper's §6 recurrence
  ``omega_j = sum_i omega_i * sigma_ij * f_ij`` (SPLIT routing divides by
  the out-edge count) — linear in the input rate, so per task
  ``rate = beta * Omega``; with a selectivity slack ``s`` every edge
  multiplier widens to ``[m(1-s), m(1+s)]`` and the betas become
  intervals;
* a (task, slot) thread group of ``q`` threads serves at most the model's
  ``I_t(q)`` (§8.4.1) and receives ``frac * beta * Omega`` of the task's
  rate (routing fractions are rate-independent);
* the §8.4.2 CPU-oversubscription penalty only ever *shrinks* capacity,
  so a cell is proved stable only when the upper-bound rate-scaled CPU
  of every slot also fits its core — otherwise the penalty could bite
  and the verdict stays unprovable.

Verdicts per (dag, rate) cell:

* ``proved_stable`` — every binding group's demand upper bound fits its
  capacity AND no slot can oversubscribe its core: the (fluid) simulator
  cannot show queue growth.  Sound because the simulator's served rate
  never exceeds demand and its effective capacity never exceeds
  ``I_t(q)``.
* ``proved_unstable`` — some group's demand LOWER bound exceeds its
  capacity by ``unstable_margin`` (RATE301), or a group with positive
  demand has zero capacity (RATE304): queues must grow regardless of
  the penalty (which only shrinks capacity further).
* ``unprovable`` — everything in between: borderline cells (RATE302) or
  cells whose stability hinges on the oversubscription fixed point
  (RATE303).

Planners use proved cells to skip co-simulation
(:meth:`repro_torch.core.online.FleetController.cosimulate` with
``prove=True``); unprovable cells still simulate.  The module needs only
numpy.

A copy of the JAX package's ``analysis/prove.py``; nothing but the module
references differs.  ``python -m repro_torch.analysis prove`` runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.diagnostics import Severity, Violation
from ..core.predictor import GroupIndex, build_group_index

PROVED_STABLE = "proved_stable"
PROVED_UNSTABLE = "proved_unstable"
UNPROVABLE = "unprovable"

#: (code, name, one-line summary) — the CLI's ``--list-rules`` and the
#: SARIF rule table draw from this.
RATE_RULES: List[Tuple[str, str, str]] = [
    ("RATE301", "proved-unstable",
     "a group's demand lower bound exceeds its §8.4.1 capacity by the "
     "unstable margin — queues must grow at this rate"),
    ("RATE302", "borderline-cell",
     "demand interval straddles capacity for some group — cell "
     "unprovable, fall back to co-simulation"),
    ("RATE303", "cpu-oversub-unprovable",
     "a slot's upper-bound rate-scaled CPU exceeds its core, so the "
     "§8.4.2 penalty may throttle capacity — cell unprovable"),
    ("RATE304", "zero-capacity-demand",
     "a group with positive demand has zero model capacity — proved "
     "unstable"),
    ("RATE305", "allocation-rate-mismatch",
     "a task's allocated rate falls outside the §6 recurrence interval "
     "for the DAG input rate — the allocation is internally inconsistent"),
    ("RATE309", "prover-simulator-disagreement",
     "a cell the prover decided disagrees with the co-simulation's "
     "verdict (emitted only by `prove --simulate`) — a soundness bug"),
]


@dataclasses.dataclass(frozen=True)
class Interval:
    """A non-negative closed interval ``[lo, hi]``."""

    lo: float
    hi: float

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def __mul__(self, other: "Interval") -> "Interval":
        # all quantities here (rates, selectivities, fractions) are >= 0
        return Interval(self.lo * other.lo, self.hi * other.hi)

    def scale(self, k: float) -> "Interval":
        return Interval(self.lo * k, self.hi * k)

    @staticmethod
    def point(x: float) -> "Interval":
        return Interval(x, x)


def beta_intervals(gi: GroupIndex,
                   selectivity_slack: float = 0.0) -> List[Interval]:
    """Per-task rate-per-unit-input intervals via the §6 recurrence.

    ``gi.in_edges`` already folds selectivity and SPLIT fan-out into one
    multiplier per edge; a slack ``s`` widens each to ``[m(1-s), m(1+s)]``.
    Tasks without in-edges (sources) anchor at the exact ``gi.betas``
    value.  Rows are in topo order, so one forward pass suffices.
    """
    s = float(selectivity_slack)
    out: List[Interval] = []
    for row, edges in enumerate(gi.in_edges):
        if not edges:
            out.append(Interval.point(float(gi.betas[row])))
            continue
        acc = Interval.point(0.0)
        for src, mult in edges:
            lo = mult * max(0.0, 1.0 - s)
            hi = mult * (1.0 + s)
            acc = acc + Interval(out[src].lo * lo, out[src].hi * hi)
        out.append(acc)
    return out


@dataclasses.dataclass
class ProofResult:
    """Verdict for one (dag, rate) cell."""

    name: str
    omega: float
    verdict: str                    # PROVED_STABLE / PROVED_UNSTABLE / ...
    margin: float                   # min over binding groups of
    #                                 capacity/demand_hi - 1 (negative when
    #                                 some demand exceeds capacity)
    binding: str                    # worst group, human-readable
    violations: List[Violation]

    @property
    def proved(self) -> bool:
        return self.verdict in (PROVED_STABLE, PROVED_UNSTABLE)


def prove_group_index(gi: GroupIndex, omega: float, *, name: str = "dag",
                      rate_slack: float = 0.0,
                      selectivity_slack: float = 0.0,
                      unstable_margin: float = 0.05) -> ProofResult:
    """Prove one schedule cell stable/unstable, or report unprovable.

    Mirrors :func:`repro_torch.core.predictor.predict_max_rate_gi`'s
    binding constraint (``g_frac * beta * Omega <= I_t(q)`` per group) with
    interval bounds, plus the §8.4.2 soundness condition on slot CPU.
    """
    cell = f"{name}@{omega:g}"
    betas = beta_intervals(gi, selectivity_slack)
    om = Interval(omega * max(0.0, 1.0 - rate_slack),
                  omega * (1.0 + rate_slack))
    viols: List[Violation] = []
    margin = float("inf")
    binding = "(no binding group)"
    borderline: List[str] = []
    all_within = True
    d_hi = np.zeros(gi.n_groups)
    for g in range(gi.n_groups):
        frac = float(gi.g_frac[g])
        d = betas[int(gi.g_task[g])] * om
        d = d.scale(frac)
        d_hi[g] = d.hi
        cap = float(gi.g_cap[g])
        if d.hi <= 0.0:
            continue                       # group receives no traffic
        label = (f"{gi.tasks[int(gi.g_task[g])]}@"
                 f"{gi.slots[int(gi.g_slot[g])]}")
        if cap <= 0.0:
            viols.append(Violation(
                "RATE304", Severity.ERROR, cell, f"{cell}/{label}",
                f"group {label} has zero model capacity but demand >= "
                f"{d.lo:g} t/s — queues must grow"))
            margin = -1.0
            binding = label
            continue
        m = cap / d.hi - 1.0
        if m < margin:
            margin, binding = m, label
        if d.lo > cap * (1.0 + unstable_margin):
            viols.append(Violation(
                "RATE301", Severity.ERROR, cell, f"{cell}/{label}",
                f"group {label} demand lower bound {d.lo:.4g} t/s exceeds "
                f"capacity {cap:.4g} by more than {unstable_margin:.0%} — "
                "proved unstable (the §8.4.2 penalty only shrinks "
                "capacity further)"))
        elif d.hi > cap * (1.0 + 1e-9):
            all_within = False
            borderline.append(
                f"{label}: demand [{d.lo:.4g}, {d.hi:.4g}] vs cap "
                f"{cap:.4g}")
    if any(v.code in ("RATE301", "RATE304") for v in viols):
        return ProofResult(name, omega, PROVED_UNSTABLE, margin, binding,
                           viols)
    if not all_within:
        viols.append(Violation(
            "RATE302", Severity.WARNING, cell, cell,
            "borderline cell — demand interval straddles capacity for: "
            + "; ".join(borderline)))
        return ProofResult(name, omega, UNPROVABLE, margin, binding, viols)
    # every group fits; stability still needs the §8.4.2 soundness check:
    # upper-bound rate-scaled CPU per slot must fit the core, else the
    # penalty could throttle capacity below demand in the simulator
    n_slots = len(gi.slots)
    if gi.n_groups and n_slots:
        frac_used = np.where(gi.g_cap > 0,
                             np.minimum(1.0, d_hi / np.where(
                                 gi.g_cap > 0, gi.g_cap, 1.0)), 1.0)
        slot_cpu = np.zeros(n_slots)
        np.add.at(slot_cpu, gi.g_slot, gi.g_cpu * frac_used)
        worst = int(np.argmax(slot_cpu))
        if slot_cpu[worst] > 1.0 + 1e-9:
            viols.append(Violation(
                "RATE303", Severity.WARNING, cell,
                f"{cell}/{gi.slots[worst]}",
                f"slot {gi.slots[worst]} upper-bound CPU "
                f"{slot_cpu[worst]:.3f} exceeds its core — the §8.4.2 "
                "oversubscription penalty may bite; cell unprovable"))
            return ProofResult(name, omega, UNPROVABLE, margin, binding,
                               viols)
    return ProofResult(name, omega, PROVED_STABLE, margin, binding, viols)


def prove_allocation(dag: "object", alloc: "object", models: "object", *,
                     rate_slack: float = 0.0,
                     selectivity_slack: float = 0.0,
                     unstable_margin: float = 0.05) -> ProofResult:
    """Mapping-independent proof obligations for an :class:`Allocation`.

    * **RATE305** — a task's recorded ``rate`` falls outside the interval
      the §6 recurrence propagates from ``alloc.omega`` (a corrupted or
      hand-edited allocation: the planner's books don't balance).
    * **RATE301** — a task's demand lower bound exceeds the best rate ANY
      mapping of its ``threads`` could serve (``tau * max_q I(q)/q``,
      the per-thread efficiency peak of §8.4.1): proved unstable before
      a mapper even runs.
    """
    from ..core.dag import Routing
    name = getattr(dag, "name", "dag")
    omega = float(alloc.omega)
    cell = f"{name}@{omega:g}"
    s = float(selectivity_slack)
    order = [t.name for t in dag.topo_order()]
    row_of = {n: i for i, n in enumerate(order)}
    betas: List[Interval] = []
    for tname in order:
        edges = dag.in_edges(tname)
        if not edges:
            betas.append(Interval.point(1.0))
            continue
        acc = Interval.point(0.0)
        for e in edges:
            mult = e.selectivity
            outs = len(dag.out_edges(e.src))
            if dag.routing[e.src] is Routing.SPLIT and outs:
                mult /= outs
            acc = acc + Interval(
                betas[row_of[e.src]].lo * mult * max(0.0, 1.0 - s),
                betas[row_of[e.src]].hi * mult * (1.0 + s))
        betas.append(acc)
    om = Interval(omega * max(0.0, 1.0 - rate_slack),
                  omega * (1.0 + rate_slack))
    viols: List[Violation] = []
    margin = float("inf")
    binding = "(no binding task)"
    for tname in order:
        ta = alloc.tasks.get(tname)
        if ta is None:
            continue
        expect = betas[row_of[tname]] * om
        tol = 1e-6 * max(1.0, expect.hi)
        if not (expect.lo - tol <= ta.rate <= expect.hi + tol):
            viols.append(Violation(
                "RATE305", Severity.ERROR, cell, f"{cell}/{tname}",
                f"allocation records rate {ta.rate:g} t/s for {tname!r} "
                f"but the §6 recurrence propagates "
                f"[{expect.lo:.6g}, {expect.hi:.6g}] from omega "
                f"{omega:g}"))
        model = models[ta.kind]
        tau = int(ta.threads)
        if tau <= 0 or expect.hi <= 0:
            continue
        per_thread = max((model.I(q) / q for q in range(1, tau + 1)),
                        default=0.0)
        best = tau * per_thread
        m = (best / expect.hi - 1.0) if expect.hi > 0 else float("inf")
        if m < margin:
            margin, binding = m, tname
        if best <= 0 or expect.lo > best * (1.0 + unstable_margin):
            viols.append(Violation(
                "RATE301", Severity.ERROR, cell, f"{cell}/{tname}",
                f"task {tname!r} demand lower bound {expect.lo:.4g} t/s "
                f"exceeds the best any mapping of {tau} threads serves "
                f"({best:.4g} = tau * max_q I(q)/q) — proved unstable"))
    verdict = (PROVED_UNSTABLE
               if any(v.code == "RATE301" for v in viols) else UNPROVABLE)
    return ProofResult(name, omega, verdict, margin, binding, viols)


def _models_for(models: "object", name: str) -> "object":
    """Per-DAG model libraries: a plain mapping of name -> library, or one
    shared library (mirrors ``repro_torch.core.fleet._models_for``)."""
    if isinstance(models, dict) and name in models:
        return models[name]
    return models


def prove_fleet(plan: "object", models: Optional[object] = None, *,
                fractions: Optional[Sequence[float]] = None,
                rate_slack: float = 0.0,
                selectivity_slack: float = 0.0,
                unstable_margin: float = 0.05
                ) -> Dict[str, List[ProofResult]]:
    """Prove every (mapped entry, fraction) cell of a fleet plan.

    The sweep axis defaults to ``simulate_fleet``'s (0.25..1.25, 9 points).
    Entries without a schedule or with zero rate are skipped, matching the
    co-simulation's ``skipped`` list.  Uses each entry's cached
    :class:`GroupIndex` when present; otherwise ``models`` is required to
    build one.
    """
    fracs = (np.linspace(0.25, 1.25, 9) if fractions is None
             else np.asarray(fractions, dtype=float))
    out: Dict[str, List[ProofResult]] = {}
    for e in plan.entries.values():
        if getattr(e, "schedule", None) is None or e.omega <= 0:
            continue
        gi = getattr(e, "group_index", None)
        if gi is None:
            if models is None:
                raise ValueError(
                    f"entry {e.name!r} has no cached GroupIndex; pass "
                    "`models` so prove_fleet can build one")
            gi = build_group_index(e.dag, e.schedule.allocation,
                                   e.schedule.mapping,
                                   _models_for(models, e.name),
                                   plan.policy)
        out[e.name] = [
            prove_group_index(gi, float(f) * e.omega, name=e.name,
                              rate_slack=rate_slack,
                              selectivity_slack=selectivity_slack,
                              unstable_margin=unstable_margin)
            for f in fracs]
    return out
