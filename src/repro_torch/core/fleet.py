"""Multi-DAG fleet planning on the vectorized slot oracle.

The §8.5 protocol answers "what rate fits a fixed cluster?" for ONE
dataflow; a production cluster hosts a *fleet* — many DAGs from many
tenants sharing one slot budget.  This module answers the joint question
"what rate does every DAG get?" model-driven:

1. one :func:`~repro_torch.core.batch.batch_slots` pass per DAG evaluates the
   slot estimate over the full (dag x rate) grid — all the allocator work
   the rate search ever does;
2. a joint bisection over the shared fairness level plus a greedy
   water-fill of the leftover slots picks per-DAG planned rates under a
   selectable objective (below);
3. each planned DAG is mapped onto its share of one common VM pool —
   §7.1 acquisition per DAG with fleet-unique VM ids, then
   :func:`repro_torch.core.scheduler.plan` with ``fixed_vms`` +
   ``grow_fixed_vms`` (the §8.4 +1-slot retry rule on mapper
   fragmentation) — yielding an ordinary per-DAG
   :class:`~repro_torch.core.scheduler.Schedule`, and the §8.5.2 sweep
   predictor reports CPU/mem per DAG and per VM;
4. :func:`simulate_fleet` closes the loop empirically: every planned
   DAG's rate sweep is co-simulated in ONE batched time loop on the
   shared VM pool (one launch of the simulator's sweep kernel on the card
   by default, ``engine="numpy"`` for the reference path), reporting
   fleet predicted-vs-actual per-VM CPU/mem and each DAG's actual max
   stable rate.

Objectives
----------
``max_min``   lexicographic max-min fair rates: raise every DAG's rate
              together as far as the budget allows, then water-fill the
              leftover slots, always advancing a currently-lowest DAG
              (cheapest increment first among ties).
``weighted``  weighted max-min on ``rate / weight``: rates stay
              proportional to the weights (proportional throughput
              shares) until grid granularity or a DAG's feasibility
              ceiling binds, then water-filling continues in ratio
              space.  Equal weights share ``max_min``'s uniform ratio
              ladder, where the greedy water-fill is exactly optimal;
              unequal weights step DAGs by different ratio increments,
              so the fill switches to the exact recursive bottleneck
              solver (:func:`_fill_exact`): maximize the minimum ratio
              by level bisection, freeze the DAGs that provably cannot
              exceed it, recurse on the rest — branching over the tied
              bottleneck only when joint advancement is unaffordable.
              Both paths are pinned against brute-force budget
              partitions in ``tests/test_fleet.py``.
``priority``  strict tiers with preemption order: higher-priority DAGs
              are planned first (weighted max-min within a tier, so
              ``weights`` compose with tiers) and lower tiers split what
              is left — when the budget shrinks, the lowest tier loses
              rate first (:meth:`FleetPlan.preemption_order`).
``min_cost``  heterogeneous cost-aware rates: the budget is expressed in
              *dollars per hour* (``budget_dollars``), each (dag, rate)
              cell is priced at the cheapest VM class that covers its
              per-class slot estimate (speed/memory-aware surfaces, one
              per class), and the same level bisection + water-fill runs
              on the $/rate surface — every increment buys rate for the
              DAG where it is cheapest.  Each planned DAG's pool is
              acquired from its chosen class.  ``weights`` compose as in
              ``weighted``.

Like ``max_planned_rate``'s bisection, the level bisection and water-fill
assume the slot surface is nondecreasing in rate within each DAG's
feasible prefix — true for LSA/MBA over the seed profiles and pinned
against brute-force budget partitions in ``tests/test_fleet.py``.

A copy of the JAX package's ``core/fleet.py``.  Besides the module
references, one thing differs: :func:`simulate_fleet` takes ``device``,
where its ``"scan"`` engine runs (``None``: the CUDA sweep kernel, which
raises without a card; ``"cpu"``: the kernel's plain PyTorch version),
and passes it on to :meth:`SweepBatch.sweep_raw`.  ``refine_search``
reaches the port's :func:`~repro_torch.core.search.search_mapping`, whose
sweeps run on the card unless ``search_opts`` says ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .allocation import UnsupportableRateError
from .batch import batch_slots, bisect_largest_true, prefix_feasible_count
from .dag import Dataflow
from .diagnostics import raise_if_errors, resolve_validate
from .mapping import (DEFAULT_VM_SIZES, VM, SlotId, VmClass, VmSizesArg,
                      acquire_vms, pool_cost_per_hour, resolve_vm_classes,
                      vm_sizes_speed)
from .perfmodel import ModelLibrary
from .predictor import (GroupIndex, ResourcePrediction, ResourceSweep,
                        build_group_index, predict_max_rate_gi,
                        predict_resources_sweep)
from .routing import RoutingPolicy
from .scheduler import Schedule, plan
from .simulator import DataflowSimulator, SimResult, SweepBatch
from ..models.common import DeviceLike
from ..obs.trace import trace as _obs_trace

ModelsArg = Union[ModelLibrary, Mapping[str, ModelLibrary]]

OBJECTIVES = ("max_min", "weighted", "priority", "min_cost")


class UnsupportableDagError(UnsupportableRateError):
    """A DAG cannot run in this fleet even at the grid's floor rate: its
    slot estimate at ``grid[0]`` exceeds the whole budget (or the rate is
    unsupportable outright).  Raised by :func:`plan_fleet` and the online
    controller's admission path instead of silently planning the DAG at
    zero rate — a *contended* zero rate (priority preemption, crowded
    budget) is normal and does not raise.  Under ``min_cost`` the budget
    is dollars per hour (``unit="$/h"``)."""

    code = "FLT_UNSUPPORTABLE_DAG"

    def __init__(self, dag: str, floor_rate: float,
                 budget_slots: Union[int, float], unit: str = "slots"):
        super().__init__(
            dag, floor_rate,
            f"DAG {dag!r} does not fit {budget_slots:g} {unit} even at its "
            f"floor rate {floor_rate:g} t/s")
        self.dag = dag
        self.budget_slots = budget_slots
        self.unit = unit

    def to_violation(self):
        from .diagnostics import Severity, Violation
        return Violation(self.code, Severity.ERROR, f"Dag[{self.dag}]",
                         f"floor_rate={self.rate:g} "
                         f"budget_slots={self.budget_slots}", str(self))


# ---------------------------------------------------------------------------
# Joint rate selection on the (dag x rate) slot surface.
# ---------------------------------------------------------------------------

def _level_indices(grid: np.ndarray, weights: np.ndarray, caps: np.ndarray,
                   theta: float) -> np.ndarray:
    """Per DAG, the largest grid index with ``grid[j] <= weight * theta``
    (clamped to the DAG's feasible prefix); ``-1`` below the first point."""
    idx = np.searchsorted(grid, weights * theta * (1 + 1e-12),
                          side="right") - 1
    return np.minimum(idx, caps - 1)


def _cost(slots: np.ndarray, idx: np.ndarray) -> float:
    """Total cost of a per-DAG grid-index vector (-1 = zero rate).  The
    surface is int slots for the slot-budget objectives and float $/hour
    for ``min_cost``; float64 sums int slot counts exactly (rows are
    clamped at 2**62)."""
    picked = np.take_along_axis(slots, np.maximum(idx, 0)[:, None],
                                axis=1)[:, 0]
    return float(np.where(idx >= 0, picked, 0).sum(dtype=np.float64))


def _bisect_common_level(grid: np.ndarray, slots: np.ndarray,
                         caps: np.ndarray, weights: np.ndarray,
                         budget: float) -> np.ndarray:
    """Largest common fairness level ``theta`` (every DAG at the largest
    grid rate <= weight * theta, capped by its own ceiling) whose total
    slot cost fits the budget — O(log(D*K)) array probes."""
    cands = [grid[:caps[d]] / weights[d] for d in range(len(weights))
             if caps[d] > 0]
    if not cands:
        return np.full(len(weights), -1, dtype=int)
    levels = np.unique(np.concatenate(cands))

    def fits(k: int) -> bool:
        return _cost(slots, _level_indices(grid, weights, caps,
                                           float(levels[k]))) <= budget

    best = bisect_largest_true(fits, len(levels))
    if best < 0:
        return np.full(len(weights), -1, dtype=int)
    return _level_indices(grid, weights, caps, float(levels[best]))


def _water_fill(grid: np.ndarray, slots: np.ndarray, caps: np.ndarray,
                weights: np.ndarray, budget: float, idx: np.ndarray
                ) -> np.ndarray:
    """Greedy lexicographic water-fill of the leftover budget: repeatedly
    advance the DAG with the lowest current ``rate/weight`` (cheapest next
    increment among ties) by one grid step; freeze it when its next step no
    longer fits.  Increment costs are nondecreasing, so frozen stays frozen.

    Exactly optimal when every DAG climbs the same ratio ladder (equal
    weights on the shared grid): ties at the minimum are then resolved by
    the cheapest increment, which maximizes how many DAGs advance.  With
    *unequal* weights the cheapest tied step can strand budget a pricier
    tied DAG would have turned into a higher ratio — :func:`_fill_exact`
    handles that case; :func:`_plan_rates` dispatches."""
    idx = idx.copy()
    total = _cost(slots, idx)

    def ratio(d: int) -> float:
        return float(grid[idx[d]] / weights[d]) if idx[d] >= 0 else 0.0

    def incr(d: int) -> float:
        nxt = float(slots[d, idx[d] + 1])
        return nxt - (float(slots[d, idx[d]]) if idx[d] >= 0 else 0.0)

    heap: List[Tuple[float, float, int]] = [
        (ratio(d), incr(d), d) for d in range(len(weights))
        if idx[d] + 1 < caps[d]]
    heapq.heapify(heap)
    while heap:
        _, inc, d = heapq.heappop(heap)
        if total + inc > budget:
            continue                      # frozen: later steps cost >= inc
        idx[d] += 1
        total += inc
        if idx[d] + 1 < caps[d]:
            heapq.heappush(heap, (ratio(d), incr(d), d))
    return idx


def _fill_exact(grid: np.ndarray, slots: np.ndarray, caps: np.ndarray,
                weights: np.ndarray, budget: float) -> np.ndarray:
    """Exact lexicographic water-fill for unequal-weight ratio ladders.

    Recursive bottleneck solver: maximize the minimum ``rate/weight`` by a
    level bisection (each DAG at its *cheapest* grid point at or above the
    level), then freeze every DAG that provably cannot exceed that level —
    its next step is unaffordable even with all others at their cheapest
    level positions, and increment costs are nondecreasing, so it never
    becomes affordable — and recurse on the rest with the leftover budget.
    When no DAG is individually stuck but the level still cannot rise (the
    tied DAGs cannot all afford their next step *jointly*), exactly one
    tied DAG must stay at the level: branch over the candidates and keep
    the lexicographically best sorted ratio vector.  The branch is bounded
    by the fleet size and only triggers on joint-affordability ties, so
    the common case stays O(D log(D·K)) array probes."""

    def min_idx(d: int, theta: float) -> Optional[int]:
        """Cheapest grid index with ``grid[j]/weight >= theta`` (-1 = zero
        rate for theta <= 0); None when the DAG cannot reach ``theta``
        within its feasible prefix."""
        if theta <= 0:
            return -1
        j = int(np.searchsorted(grid, weights[d] * theta * (1 - 1e-12),
                                side="left"))
        return j if j < caps[d] else None

    def cost(d: int, j: int) -> float:
        return float(slots[d, j]) if j >= 0 else 0.0

    def ratio(d: int, j: int) -> float:
        return float(grid[j] / weights[d]) if j >= 0 else 0.0

    def solve(active: List[int], b: int) -> Dict[int, int]:
        if not active:
            return {}
        ladders = [grid[:caps[d]] / weights[d] for d in active if caps[d] > 0]
        levels = (np.unique(np.concatenate([np.zeros(1)] + ladders))
                  if ladders else np.zeros(1))

        def fits(k: int) -> bool:
            total = 0.0
            for d in active:
                j = min_idx(d, float(levels[k]))
                if j is None:
                    return False
                total += cost(d, j)
            return total <= b

        # level 0.0 always fits (zero rate costs nothing), so best >= 0
        best = bisect_largest_true(fits, len(levels))
        m_star = float(levels[best]) if best >= 0 else 0.0
        base = {d: min_idx(d, m_star) for d in active}
        base_cost = sum(cost(d, j) for d, j in base.items())
        stuck = []
        for d in active:
            nxt = base[d] + 1
            if nxt >= caps[d] or \
                    base_cost - cost(d, base[d]) + float(slots[d, nxt]) > b:
                stuck.append(d)
        if stuck:
            rest = [d for d in active if d not in stuck]
            sub = solve(rest, b - sum(cost(d, base[d]) for d in stuck))
            sub.update({d: base[d] for d in stuck})
            return sub
        # every bottleneck DAG could advance alone, yet the level cannot
        # rise: they cannot all afford the step jointly, so exactly one DAG
        # at the minimum ratio must stay — branch over which
        rmin = min(ratio(d, base[d]) for d in active)
        at_level = [d for d in active
                    if ratio(d, base[d]) <= rmin * (1 + 1e-9) + 1e-12]
        best_sol: Dict[int, int] = {}
        best_key = None
        for c in at_level:
            rest = [d for d in active if d != c]
            sub = solve(rest, b - cost(c, base[c]))
            sub[c] = base[c]
            key = tuple(sorted(ratio(d, j) for d, j in sub.items()))
            if best_key is None or key > best_key:
                best_sol, best_key = sub, key
        return best_sol

    sol = solve(list(range(len(weights))), float(budget))
    return np.array([sol[d] for d in range(len(weights))], dtype=int)


def _plan_rates(grid: np.ndarray, slots: np.ndarray, caps: np.ndarray,
                weights: np.ndarray, budget: float) -> np.ndarray:
    """Joint bisection to the common fairness level, then water-fill; with
    unequal weights the greedy fill is not exact (DAGs step by different
    ratio increments), so the recursive bottleneck solver runs instead."""
    if len(weights) and float(np.ptp(weights)) > 1e-12:
        return _fill_exact(grid, slots, caps, weights, budget)
    idx = _bisect_common_level(grid, slots, caps, weights, budget)
    return _water_fill(grid, slots, caps, weights, budget, idx)


# ---------------------------------------------------------------------------
# Cached per-DAG slot surfaces + the shared rate-selection pass.
# ---------------------------------------------------------------------------

class SlotSurfaceCache:
    """Per-DAG ``(rate x slots)`` surfaces on one shared grid, computed at
    most once per DAG.

    The surface — :func:`~repro_torch.core.batch.batch_slots` over the
    grid — is all the allocator work fleet rate selection ever needs, and it only
    depends on (dag, models, allocator, grid), never on the budget or the
    rest of the fleet.  Caching it is what makes event-driven replanning
    incremental: :func:`replan_incremental` re-runs the joint level
    bisection + water-fill as pure array probes over the cached rows, and a
    new surface is computed solely when a DAG first *arrives*.
    ``stats`` counts ``batch_passes`` (vectorized grid computations) and
    ``hits`` (reuses)."""

    def __init__(self, *, allocator: str = "mba", step: float = 10.0,
                 max_rate: float = 1e4,
                 surface_class: Optional[VmClass] = None):
        self.allocator = allocator
        self.step = float(step)
        self.max_rate = float(max_rate)
        #: when set, every plain :meth:`surface`/:meth:`row` is computed at
        #: this class's speed/mem_per_slot — the online controller's way of
        #: running a whole cache on one non-unit VM family (the incremental
        #: replanner reads ``row()`` directly)
        self.surface_class = surface_class
        self.grid = step * np.arange(1, int(max_rate / step) + 1)
        self._rows: Dict[str, np.ndarray] = {}
        #: per-class rows keyed ``(name, speed, mem_per_slot)`` — unit
        #: classes share the plain row in ``_rows``
        self._class_rows: Dict[Tuple[str, float, float], np.ndarray] = {}
        self._prints: Dict[str, Tuple] = {}
        self.stats = {"batch_passes": 0, "hits": 0}

    def __contains__(self, name: str) -> bool:
        return name in self._rows

    @staticmethod
    def _fingerprint(dag: Dataflow) -> Tuple:
        """Structural identity of a DAG: the surface depends only on task
        kinds and edge selectivities (via the rate coefficients), so a
        renamed *object* with the same structure is a legitimate hit,
        while a different dataflow reusing a cached name must not be."""
        return (dag.name,
                tuple(sorted((t.name, t.kind) for t in dag.tasks.values())),
                tuple(sorted((e.src, e.dst, e.selectivity)
                             for e in dag.edges)))

    def surface(self, name: str, dag: Dataflow,
                models: ModelLibrary) -> np.ndarray:
        """The cached slot row for ``name``, computing it on first use.
        A structurally different DAG under a cached name raises
        ``ValueError`` rather than silently returning the stale row (the
        models are assumed stable per name for the cache's lifetime)."""
        row = self._rows.get(name)
        if row is None:
            self.stats["batch_passes"] += 1
            sc = self.surface_class
            row = batch_slots(dag, self.grid, models, self.allocator,
                              clip_unsupportable=True,
                              speed=sc.speed if sc else 1.0,
                              mem_per_slot=sc.mem_per_slot if sc else 1.0)
            self._rows[name] = row
            self._prints[name] = self._fingerprint(dag)
        else:
            if self._prints[name] != self._fingerprint(dag):
                raise ValueError(
                    f"surface cache holds a structurally different DAG "
                    f"under the name {name!r}; drop() it first")
            self.stats["hits"] += 1
        return row

    def class_surface(self, name: str, dag: Dataflow, models: ModelLibrary,
                      vm_class: VmClass) -> np.ndarray:
        """The slot row for ``name`` on a specific VM class: computed at the
        class's slot speed (effective per-thread rate) and ``mem_per_slot``,
        cached per ``(dag, speed, mem_per_slot)``.  A unit class shares the
        plain :meth:`surface` row, so homogeneous baselines stay on the
        bit-identical path."""
        if vm_class.speed == 1.0 and vm_class.mem_per_slot == 1.0:
            return self.surface(name, dag, models)
        key = (name, float(vm_class.speed), float(vm_class.mem_per_slot))
        row = self._class_rows.get(key)
        if row is None:
            fp = self._fingerprint(dag)
            if name in self._prints and self._prints[name] != fp:
                raise ValueError(
                    f"surface cache holds a structurally different DAG "
                    f"under the name {name!r}; drop() it first")
            self.stats["batch_passes"] += 1
            row = batch_slots(dag, self.grid, models, self.allocator,
                              clip_unsupportable=True, speed=vm_class.speed,
                              mem_per_slot=vm_class.mem_per_slot)
            self._class_rows[key] = row
            self._prints.setdefault(name, fp)
        else:
            self.stats["hits"] += 1
        return row

    def row(self, name: str) -> np.ndarray:
        """The cached row, without computing (KeyError when absent)."""
        return self._rows[name]

    def names(self) -> List[str]:
        """Names with a cached surface, in insertion order."""
        return list(self._rows)

    def drop(self, name: str) -> None:
        """Forget a departed DAG's surface (class rows included)."""
        self._rows.pop(name, None)
        self._prints.pop(name, None)
        for key in [k for k in self._class_rows if k[0] == name]:
            del self._class_rows[key]


def _caps_for(grid: np.ndarray, slots: np.ndarray, names: Sequence[str],
              budget_slots: Union[int, float],
              max_rates: Optional[Mapping[str, float]] = None,
              *, floor_check: bool = True, unit: str = "slots") -> np.ndarray:
    """Per-DAG feasible-prefix lengths under ``budget_slots``, clamped by
    each DAG's offered-load ceiling (``max_rates``, t/s).  With
    ``floor_check`` a DAG that cannot fit the whole budget even at the
    grid's first rate raises :class:`UnsupportableDagError` — a demand
    ceiling of zero, by contrast, is a legitimate throttle and never
    raises.  ``min_cost`` passes its $/hour surface with ``unit="$/h"``."""
    caps = np.empty(len(names), dtype=int)
    for d, name in enumerate(names):
        cap = prefix_feasible_count(slots[d] <= budget_slots)
        if cap == 0 and floor_check:
            raise UnsupportableDagError(name, float(grid[0]),
                                        budget_slots, unit)
        demand = (max_rates or {}).get(name)
        if demand is not None and np.isfinite(demand):
            cap = min(cap, int(np.searchsorted(grid, demand * (1 + 1e-12),
                                               side="right")))
        caps[d] = cap
    return caps


def _select_rates(grid: np.ndarray, slots: np.ndarray, caps: np.ndarray,
                  weights: np.ndarray, prio: np.ndarray, objective: str,
                  budget_slots: Union[int, float]) -> np.ndarray:
    """Joint per-DAG grid indices under ``objective`` — the pure rate
    selection shared by :func:`plan_fleet` and :func:`replan_incremental`
    (identical inputs give identical rates by construction).  For
    ``min_cost`` the surface/budget are $/hour and weights compose as in
    ``weighted``."""
    D = len(weights)
    if objective == "priority":
        idx = np.full(D, -1, dtype=int)
        residual = budget_slots
        for p in sorted(set(prio.tolist()), reverse=True):
            tier = np.flatnonzero(prio == p)
            if residual <= 0:
                break
            tier_idx = _plan_rates(grid, slots[tier], caps[tier],
                                   weights[tier], residual)
            idx[tier] = tier_idx
            residual -= _cost(slots[tier], tier_idx)
        return idx
    use_w = weights if objective in ("weighted", "min_cost") else np.ones(D)
    return _plan_rates(grid, slots, caps, use_w, budget_slots)


@dataclasses.dataclass(frozen=True)
class RateDecision:
    """One DAG's share of an incremental rate-selection pass."""

    name: str
    omega: float                 # planned rate (0.0 = contended out)
    grid_index: int              # index into the shared grid, -1 for 0.0
    estimated_slots: int         # slot estimate at the planned rate


@_obs_trace("replan_incremental")
def replan_incremental(cache: SlotSurfaceCache, names: Sequence[str], *,
                       budget_slots: int, objective: str = "max_min",
                       weights: Optional[Mapping[str, float]] = None,
                       priorities: Optional[Mapping[str, int]] = None,
                       max_rates: Optional[Mapping[str, float]] = None,
                       validate: Optional[bool] = None
                       ) -> Dict[str, RateDecision]:
    """Re-run ONLY the joint rate selection over cached slot surfaces.

    The incremental counterpart of :func:`plan_fleet` steps 1–2: every DAG
    in ``names`` must already have a surface in ``cache`` (arrivals compute
    theirs via :meth:`SlotSurfaceCache.surface` first), and the level
    bisection + water-fill run as array probes with ZERO allocator calls.
    Produces rates identical to a full ``plan_fleet`` of the same DAG set,
    budget, and objective — the contract the online controller's tests
    pin."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown fleet objective {objective!r}")
    if objective == "min_cost":
        raise ValueError(
            "min_cost is a plan_fleet-only objective (it needs per-class "
            "cost surfaces); the online controller sizes cost-aware pools "
            "with self_size=True instead")
    if budget_slots <= 0:
        raise ValueError("budget_slots must be positive")
    if not names:
        return {}
    w = np.array([float((weights or {}).get(n, 1.0)) for n in names])
    if np.any(w <= 0):
        raise ValueError("weights must be positive")
    prio = np.array([int((priorities or {}).get(n, 0)) for n in names])
    slots = np.stack([cache.row(n) for n in names])
    caps = _caps_for(cache.grid, slots, names, budget_slots, max_rates)
    idx = _select_rates(cache.grid, slots, caps, w, prio, objective,
                        budget_slots)
    decisions = {n: RateDecision(
        name=n, omega=float(cache.grid[idx[d]]) if idx[d] >= 0 else 0.0,
        grid_index=int(idx[d]),
        estimated_slots=int(slots[d, idx[d]]) if idx[d] >= 0 else 0)
        for d, n in enumerate(names)}
    if resolve_validate(validate):
        from ..analysis.verify import verify_rate_decisions
        raise_if_errors(
            verify_rate_decisions(cache.grid, decisions, budget_slots),
            "replan_incremental")
    return decisions


# ---------------------------------------------------------------------------
# Fleet plan result.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetEntry:
    """One DAG's share of the fleet plan."""

    name: str
    dag: Dataflow
    weight: float
    priority: int
    omega: float                 # planned DAG input rate (0.0 = preempted)
    grid_index: int              # index into FleetPlan.grid, -1 for 0.0
    estimated_slots: int         # rho at the planned rate (0 when omega=0)
    schedule: Optional[Schedule]           # None when unmapped / omega=0
    prediction: Optional[ResourcePrediction]  # §8.5.2 at the planned rate
    group_index: Optional[GroupIndex] = None  # flat view, plan's policy
    #: min_cost only: the VM class this DAG's pool draws from and the
    #: surface's $/hour estimate at the planned rate
    vm_class: str = ""
    est_cost_per_hour: float = 0.0

    @property
    def acquired_slots(self) -> int:
        return self.schedule.acquired_slots if self.schedule else 0

    @property
    def cost_per_hour(self) -> float:
        """Actual $/hour of this DAG's acquired pool (0 when unmapped)."""
        return pool_cost_per_hour(self.schedule.vms) if self.schedule else 0.0


@dataclasses.dataclass
class FleetPlan:
    """Joint plan for a fleet of DAGs sharing one cluster slot budget."""

    objective: str
    budget_slots: Optional[int]           # None under min_cost ($ budget)
    grid: np.ndarray                      # (K,) shared rate grid
    slots_matrix: np.ndarray              # (D, K) slot estimates per DAG
    entries: Dict[str, FleetEntry]        # insertion order = input order
    pool: List[VM]                        # every VM acquired for the fleet
    overflow_slots: int                   # acquired slots beyond the budget
    policy: RoutingPolicy                 # routing the predictions assume
    #: min_cost only: the $ budget, the (D, K) cheapest-class $/hour
    #: surface, the (D, K) winning class index per cell, and the classes
    #: the indices refer to
    budget_dollars: Optional[float] = None
    cost_matrix: Optional[np.ndarray] = None
    class_matrix: Optional[np.ndarray] = None
    vm_classes: Tuple[VmClass, ...] = ()

    @property
    def total_estimated_slots(self) -> int:
        return sum(e.estimated_slots for e in self.entries.values())

    @property
    def cost_per_hour(self) -> float:
        """Actual $/hour of the whole acquired pool (§7.1 pricing, class
        prices when the VMs carry them)."""
        return pool_cost_per_hour(self.pool)

    @property
    def total_acquired_slots(self) -> int:
        return sum(e.acquired_slots for e in self.entries.values())

    @property
    def total_rate(self) -> float:
        return sum(e.omega for e in self.entries.values())

    @property
    def vm_cpu(self) -> Dict[int, float]:
        """Fleet-level predicted CPU% per VM id (sum over DAGs)."""
        out: Dict[int, float] = {}
        for e in self.entries.values():
            if e.prediction:
                for vm, c in e.prediction.vm_cpu.items():
                    out[vm] = out.get(vm, 0.0) + c
        return out

    @property
    def vm_mem(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for e in self.entries.values():
            if e.prediction:
                for vm, m in e.prediction.vm_mem.items():
                    out[vm] = out.get(vm, 0.0) + m
        return out

    def preemption_order(self) -> List[str]:
        """Running DAGs in the order they would be preempted under budget
        pressure: lowest priority tier first; within a tier, the highest
        rate (most slots reclaimed) first."""
        running = [e for e in self.entries.values() if e.omega > 0]
        return [e.name for e in sorted(
            running, key=lambda e: (e.priority, -e.omega, e.name))]

    def describe(self) -> str:
        budget = (f"budget={self.budget_slots} slots"
                  if self.budget_slots is not None
                  else f"budget=${self.budget_dollars:g}/h "
                       f"(${self.cost_per_hour:.3f}/h acquired)")
        lines = [f"FleetPlan[{self.objective}] {budget}, "
                 f"{len(self.entries)} DAGs, "
                 f"est {self.total_estimated_slots} / "
                 f"acq {self.total_acquired_slots} slots "
                 f"(+{self.overflow_slots} overflow)"]
        for e in self.entries.values():
            sched = (f"vms={[vm.id for vm in e.schedule.vms]}"
                     if e.schedule else "unmapped")
            cpu = (f" cpu={sum(e.prediction.vm_cpu.values()):.2f}"
                   f" mem={sum(e.prediction.vm_mem.values()):.2f}"
                   if e.prediction else "")
            lines.append(
                f"  {e.name}: rate={e.omega:g} t/s (w={e.weight:g}, "
                f"prio={e.priority}) slots={e.estimated_slots} {sched}{cpu}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The planner.
# ---------------------------------------------------------------------------

def _normalize_dags(dags) -> Dict[str, Dataflow]:
    if isinstance(dags, Mapping):
        return dict(dags)
    out: Dict[str, Dataflow] = {}
    for d in dags:
        if d.name in out:
            raise ValueError(f"duplicate DAG name {d.name!r}")
        out[d.name] = d
    return out


def _models_for(models: ModelsArg, name: str) -> ModelLibrary:
    if isinstance(models, ModelLibrary):
        return models
    return models[name]


@_obs_trace("plan_fleet")
def plan_fleet(dags, models: ModelsArg, *, budget_slots: Optional[int] = None,
               budget_dollars: Optional[float] = None,
               objective: str = "max_min",
               weights: Optional[Mapping[str, float]] = None,
               priorities: Optional[Mapping[str, int]] = None,
               max_rates: Optional[Mapping[str, float]] = None,
               allocator: str = "mba", mapper: Optional[str] = "sam",
               step: float = 10.0, max_rate: float = 1e4,
               vm_sizes: VmSizesArg = DEFAULT_VM_SIZES,
               policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
               refine_search: bool = False,
               search_opts: Optional[Dict] = None,
               surface_cache: Optional[SlotSurfaceCache] = None,
               stats: Optional[Dict[str, int]] = None,
               validate: Optional[bool] = None) -> FleetPlan:
    """Share ``budget_slots`` across ``dags`` under ``objective``.

    ``dags`` is a name->Dataflow mapping or a sequence of Dataflows;
    ``models`` a shared :class:`ModelLibrary` or a per-DAG-name mapping of
    libraries (multi-tenant fleets profile their own task kinds).
    ``weights`` (default 1.0) scale the ``weighted`` objective;
    ``priorities`` (default 0, larger = more important) define the
    ``priority`` tiers.  ``max_rates`` (optional, t/s per DAG name) caps a
    DAG's planned rate at its offered load, releasing the budget beyond it
    to the rest of the fleet.  ``mapper=None`` plans rates only (no VM
    pool, no thread mappings) — the pure array-pass path used for
    optimality tests.  A DAG that cannot fit ``budget_slots`` even at the
    grid's floor rate raises :class:`UnsupportableDagError` (a *contended*
    zero rate under budget pressure stays a normal plan entry).

    ``vm_sizes`` also accepts :class:`~repro_torch.core.mapping.VmClass`
    objects or a registered family name.  Slot-budget objectives require a common
    slot speed and ``mem_per_slot`` across classes (their single surface is
    computed class-aware); ``objective="min_cost"`` instead takes a
    ``budget_dollars`` $/hour budget (``budget_slots`` must be omitted),
    prices every (dag, rate) cell at its cheapest covering class — one
    speed/memory-aware surface per class — and water-fills dollars, so
    classes may freely mix speeds, prices, and memory shapes; each planned
    DAG acquires its pool from its winning class.

    ``surface_cache`` reuses / persists the per-DAG slot surfaces (its
    allocator and grid must match this call); cached DAGs skip their
    vectorized grid pass entirely — the online controller's path.

    ``refine_search`` runs the opt-in simulation-guided refinement pass
    (:func:`repro_torch.core.search.search_mapping`) over each planned DAG's
    pinned VM subset: the base mapper's own mapping competes against the
    whole candidate pool on the batched sweep kernel, and a strictly better
    candidate replaces it (``Schedule.mapper`` becomes ``"search"`` with
    the winner's name in ``search_winner``).  The pool is NOT grown — the
    refinement never spends slots beyond the §8.4 retries the base mapper
    already paid.  ``search_opts`` forwards keyword overrides (e.g. tiny
    grids for CI); keys the refinement owns — pool, allocation, allocator,
    routing policy — are reserved and raise ``ValueError``.

    ``stats`` (optional) is filled with ``batch_passes`` (vectorized grid
    passes, one per DAG), ``allocator_calls`` and ``mapper_calls`` (scalar
    calls, one per mapping attempt) — plus, under ``refine_search``,
    ``search_candidates`` (total pool size evaluated) and
    ``search_improved`` (DAGs whose mapping the search beat) — for
    comparison against per-DAG scans.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown fleet objective {objective!r}")
    min_cost = objective == "min_cost"
    if min_cost:
        if budget_dollars is None or budget_dollars <= 0:
            raise ValueError("min_cost needs a positive budget_dollars")
        if budget_slots is not None:
            raise ValueError("min_cost budgets dollars, not slots; omit "
                             "budget_slots")
    else:
        if budget_dollars is not None:
            raise ValueError("budget_dollars applies only to "
                             "objective='min_cost'")
        if budget_slots is None or budget_slots <= 0:
            raise ValueError("budget_slots must be positive")
    dag_map = _normalize_dags(dags)
    names = list(dag_map)
    D = len(names)
    if D == 0:
        raise ValueError("plan_fleet needs at least one DAG")
    w = np.array([float((weights or {}).get(n, 1.0)) for n in names])
    if np.any(w <= 0):
        raise ValueError("weights must be positive")
    prio = np.array([int((priorities or {}).get(n, 0)) for n in names])
    counters = stats if stats is not None else {}
    counters.setdefault("batch_passes", 0)
    counters.setdefault("allocator_calls", 0)
    counters.setdefault("mapper_calls", 0)
    if refine_search:
        counters.setdefault("search_candidates", 0)
        counters.setdefault("search_improved", 0)

    # resolve the class view of vm_sizes; plain int sizes under a slot
    # budget stay on the anonymous legacy path (classes=None), which is the
    # bit-identical homogeneous baseline
    has_classes = isinstance(vm_sizes, str) \
        or any(isinstance(s, VmClass) for s in vm_sizes)
    classes = resolve_vm_classes(vm_sizes) if (min_cost or has_classes) \
        else None
    surf_class: Optional[VmClass] = None
    if classes is not None and not min_cost:
        speed = vm_sizes_speed(vm_sizes)    # raises on mixed speeds
        mems = {c.mem_per_slot for c in classes}
        if len(mems) > 1:
            raise ValueError("slot-budget objectives need one mem_per_slot "
                             "across classes; use objective='min_cost' for "
                             "per-class surfaces")
        mem = mems.pop()
        if speed != 1.0 or mem != 1.0:
            surf_class = VmClass("_surface", 1, speed=speed,
                                 mem_per_slot=mem)

    # 1. the whole (dag x rate) slot surface, one array pass per DAG (and,
    # under min_cost, per class) — skipped per row when a surface cache
    # already holds it
    if surface_cache is not None:
        if surface_cache.allocator != allocator:
            raise ValueError(
                f"surface cache allocator {surface_cache.allocator!r} does "
                f"not match plan_fleet allocator {allocator!r}")
        if surface_cache.step != step or surface_cache.max_rate != max_rate:
            raise ValueError("surface cache grid does not match "
                             "plan_fleet step/max_rate")
        grid = surface_cache.grid
    else:
        grid = step * np.arange(1, int(max_rate / step) + 1)

    def _surface_row(n: str, c: Optional[VmClass]) -> np.ndarray:
        lib = _models_for(models, n)
        if surface_cache is not None:
            passes0 = surface_cache.stats["batch_passes"]
            row = (surface_cache.class_surface(n, dag_map[n], lib, c)
                   if c is not None
                   else surface_cache.surface(n, dag_map[n], lib))
            counters["batch_passes"] += \
                surface_cache.stats["batch_passes"] - passes0
            return row
        counters["batch_passes"] += 1
        return batch_slots(dag_map[n], grid, lib, allocator,
                           clip_unsupportable=True,
                           speed=c.speed if c else 1.0,
                           mem_per_slot=c.mem_per_slot if c else 1.0)

    cost_matrix = class_matrix = None
    if min_cost:
        # (C, D, K) per-class slot surfaces -> $/hour per cell: VMs needed
        # (ceil) x class price; clipped-unsupportable cells are infinitely
        # expensive so no dollar budget ever fits them
        class_rows = np.stack([[_surface_row(n, c) for n in names]
                               for c in classes])
        costs = np.empty(class_rows.shape, dtype=float)
        for ci, c in enumerate(classes):
            n_vms = -(-class_rows[ci] // c.slots)
            costs[ci] = n_vms * c.cost_per_hour
        costs[class_rows >= 2 ** 61] = np.inf
        cost_matrix = np.min(costs, axis=0)
        class_matrix = np.argmin(costs, axis=0)   # ties -> first class
        slots = np.take_along_axis(np.moveaxis(class_rows, 0, -1),
                                   class_matrix[..., None], axis=-1)[..., 0]
        budget: Union[int, float] = float(budget_dollars)
        caps = _caps_for(grid, cost_matrix, names, budget, max_rates,
                         unit="$/h")
        surface = cost_matrix
    else:
        slots = np.stack([_surface_row(n, surf_class) for n in names])
        budget = budget_slots
        caps = _caps_for(grid, slots, names, budget_slots, max_rates)
        surface = slots

    # 2. joint rate selection (on the $/hour surface under min_cost)
    idx = _select_rates(grid, surface, caps, w, prio, objective, budget)

    # 3. map each planned DAG onto its share of one common VM pool: §7.1
    # acquisition per DAG (D3/D2/D1 sizes cover rho exactly; under min_cost
    # each DAG acquires from its winning class), fleet-unique VM ids, and
    # the §8.4 +1-slot retry on mapper fragmentation
    pool: List[VM] = []
    next_id = 0
    entries: Dict[str, FleetEntry] = {}
    order = sorted(range(D), key=lambda d: (-prio[d],
                                            -(slots[d, idx[d]]
                                              if idx[d] >= 0 else 0),
                                            names[d]))
    schedules: Dict[str, Optional[Schedule]] = {n: None for n in names}
    for d in order:
        name = names[d]
        if idx[d] < 0 or mapper is None:
            continue
        omega = float(grid[idx[d]])
        rho = int(slots[d, idx[d]])
        acq_sizes: VmSizesArg = vm_sizes
        if min_cost:
            acq_sizes = (classes[int(class_matrix[d, idx[d]])],)
        subset = [dataclasses.replace(vm, id=next_id + i)
                  for i, vm in enumerate(acquire_vms(rho, acq_sizes))]
        next_id += len(subset)
        lib = _models_for(models, name)
        counters["allocator_calls"] += 1
        sched = plan(dag_map[name], omega, lib, allocator=allocator,
                     mapper=mapper, fixed_vms=subset, grow_fixed_vms=True)
        # one mapper attempt per §8.4 retry (each retry adds one slot)
        counters["mapper_calls"] += 1 + len(sched.vms) - len(subset)
        if refine_search:
            sched = _refine_schedule(sched, lib, policy, search_opts,
                                     counters)
        schedules[name] = sched
        next_id = max(vm.id for vm in sched.vms) + 1
        pool.extend(sched.vms)
    overflow = (max(0, sum(vm.num_slots for vm in pool) - budget_slots)
                if budget_slots is not None else 0)

    # 4. per-DAG §8.5.2 predictions at the planned rates (sweep predictor)
    for d, name in enumerate(names):
        omega = float(grid[idx[d]]) if idx[d] >= 0 else 0.0
        sched = schedules[name]
        gi = prediction = None
        if sched is not None:
            gi = build_group_index(dag_map[name], sched.allocation,
                                   sched.mapping, _models_for(models, name),
                                   policy)
            prediction = predict_resources_sweep(
                gi, [omega], mapping=sched.mapping).at(0)
        vm_class = est_cost = None
        if min_cost and idx[d] >= 0:
            vm_class = classes[int(class_matrix[d, idx[d]])].name
            est_cost = float(cost_matrix[d, idx[d]])
        entries[name] = FleetEntry(
            name=name, dag=dag_map[name], weight=float(w[d]),
            priority=int(prio[d]), omega=omega, grid_index=int(idx[d]),
            estimated_slots=int(slots[d, idx[d]]) if idx[d] >= 0 else 0,
            schedule=sched, prediction=prediction, group_index=gi,
            vm_class=vm_class or "", est_cost_per_hour=est_cost or 0.0)
    plan_obj = FleetPlan(objective=objective, budget_slots=budget_slots,
                         grid=grid, slots_matrix=slots, entries=entries,
                         pool=pool, overflow_slots=overflow, policy=policy,
                         budget_dollars=budget_dollars,
                         cost_matrix=cost_matrix, class_matrix=class_matrix,
                         vm_classes=classes or ())
    if resolve_validate(validate):
        from ..analysis.verify import verify_fleet_plan
        raise_if_errors(verify_fleet_plan(plan_obj, models), "plan_fleet")
    return plan_obj


def _refine_schedule(sched: Schedule, models: ModelLibrary,
                     policy: RoutingPolicy, search_opts: Optional[Dict],
                     counters: Dict[str, int]) -> Schedule:
    """One DAG's simulation-guided refinement on its pinned VM subset: the
    base mapping is part of the candidate pool, so the winner is never
    worse; replace the schedule only on a strict simulated-rate win."""
    from .mapping import mapping_signature
    from .search import RESERVED_SEARCH_OPTS, search_mapping
    opts = dict(search_opts or {})
    bad = (RESERVED_SEARCH_OPTS | {"policy"}) & set(opts)
    if bad:
        raise ValueError(f"search_opts may not override {sorted(bad)} "
                         "(owned by the fleet refinement pass)")
    ranked = search_mapping(
        sched.dag, sched.omega, models, allocator=sched.allocator,
        allocation=sched.allocation, policy=policy, vms=list(sched.vms),
        grow_pool=False, **opts)
    counters["search_candidates"] += len(ranked.candidates)
    best = ranked.best
    # the base mapper's own mapping is in the pool, but possibly deduped
    # under another candidate's name (signature-identical mappers), so look
    # it up by co-location signature, not by mapper name
    base_sig = mapping_signature(sched.mapping)
    base = next((c for c in ranked.candidates
                 if mapping_signature(c.mapping) == base_sig), None)
    base_rate = base.max_stable_rate if base is not None else -1.0
    if best.max_stable_rate > base_rate:
        counters["search_improved"] += 1
        return dataclasses.replace(sched, mapping=best.mapping,
                                   mapper="search", search_winner=best.name)
    return sched


def fleet_resource_surfaces(fleet: FleetPlan, models: ModelsArg,
                            omegas: Optional[Sequence[float]] = None,
                            policy: Optional[RoutingPolicy] = None
                            ) -> Dict[str, ResourceSweep]:
    """Per-DAG predicted CPU/mem surfaces over a rate sweep (defaults to the
    plan's own grid up to each DAG's planned rate) — one array pass per DAG
    via :func:`predict_resources_sweep`.  Uses the plan's cached
    :class:`GroupIndex` unless a different routing ``policy`` is asked for."""
    policy = policy or fleet.policy
    out = {}
    for name, e in fleet.entries.items():
        if e.schedule is None:
            continue
        gi = e.group_index
        if gi is None or policy is not fleet.policy:
            gi = build_group_index(e.dag, e.schedule.allocation,
                                   e.schedule.mapping,
                                   _models_for(models, name), policy)
        sweep = (np.asarray(omegas, dtype=float) if omegas is not None
                 else fleet.grid[:e.grid_index + 1])
        out[name] = predict_resources_sweep(gi, sweep,
                                            mapping=e.schedule.mapping)
    return out


# ---------------------------------------------------------------------------
# Fleet-level simulation: predicted vs ACTUAL on the shared VM pool.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetSimEntry:
    """One DAG's empirical leg of the fleet study."""

    name: str
    omega_planned: float          # the fleet plan's rate for this DAG
    omegas: np.ndarray            # (K,) swept rates (fractions x planned)
    results: List[SimResult]      # one per swept rate ([] when proved)
    predicted_max_rate: float     # §8.5 model prediction (no §8.4.2 penalty)
    actual_max_stable: float      # largest swept rate the simulation sustains
    #: set when the static prover (repro_torch.analysis.prove) decided every
    #: cell
    #: of this entry's sweep and the simulation was skipped: the planned
    #: cell's verdict ("proved_stable" / "proved_unstable"); None when the
    #: entry was actually simulated
    proved: Optional[str] = None

    @property
    def planned_is_stable(self) -> bool:
        """Did the simulation sustain the rate the planner promised?"""
        return self.actual_max_stable >= self.omega_planned


@dataclasses.dataclass
class FleetSimReport:
    """Fleet predicted-vs-actual study (the paper's Figs. 10-12 protocol,
    run jointly for every planned DAG on the shared VM pool).

    ``vm_cpu_predicted``/``vm_mem_predicted`` are the §8.5.2 model surfaces
    and the ``_actual`` counterparts the co-simulation's served-rate draw
    (proportional C/M scale-down on what each group *actually* served, the
    noise-free analogue of
    :func:`repro_torch.core.simulator.measured_resources`)
    — both evaluated at ``at_fraction`` of the planned rates (the fraction
    closest to 1.0), so the comparison never mixes operating points.
    ``slot_busy`` sums each union-pool slot's per-group thread utilizations
    at the same column (a slot hosting several saturated groups reads above
    1.0).
    """

    fractions: np.ndarray
    at_fraction: float
    entries: Dict[str, FleetSimEntry]
    skipped: List[str]                  # DAGs with no mapping / zero rate
    vm_cpu_predicted: Dict[int, float]
    vm_mem_predicted: Dict[int, float]
    vm_cpu_actual: Dict[int, float]
    vm_mem_actual: Dict[int, float]
    slot_busy: Dict[SlotId, float]
    policy: RoutingPolicy
    engine: str

    def describe(self) -> str:
        lines = [f"FleetSimReport[{self.policy.value}, engine={self.engine}] "
                 f"{len(self.entries)} DAGs simulated"
                 + (f", skipped {self.skipped}" if self.skipped else "")]
        for e in self.entries.values():
            lines.append(
                f"  {e.name}: planned {e.omega_planned:g} t/s, predicted max "
                f"{e.predicted_max_rate:.1f}, actual max stable "
                f"{e.actual_max_stable:g}"
                f" ({'OK' if e.planned_is_stable else 'MISSES PLAN'})")
        for vm in sorted(self.vm_cpu_predicted):
            lines.append(
                f"  vm{vm}: cpu predicted {self.vm_cpu_predicted[vm]:.2f} / "
                f"actual {self.vm_cpu_actual.get(vm, 0.0):.2f}, "
                f"mem predicted {self.vm_mem_predicted[vm]:.2f} / "
                f"actual {self.vm_mem_actual.get(vm, 0.0):.2f}")
        return "\n".join(lines)


def simulate_fleet(fleet: FleetPlan, models: ModelsArg, *,
                   fractions: Optional[Sequence[float]] = None,
                   duration: float = 20.0, dt: float = 0.05,
                   warmup: float = 5.0, latency_sample_every: float = 0.25,
                   engine: str = "scan",
                   policy: Optional[RoutingPolicy] = None,
                   cpu_penalty: bool = True,
                   reuse_group_index: bool = False,
                   device: DeviceLike = None) -> FleetSimReport:
    """Co-simulate every planned DAG's rate sweep in ONE batched time loop.

    Each mapped DAG is swept over ``fractions`` of its planned rate (the
    shared sweep axis; defaults to 0.25..1.25 including 1.0), all DAGs
    advancing together through a single :class:`SweepBatch` pass over the
    fleet's union VM pool — under ``engine="scan"`` that is one launch of
    the sweep kernel for the entire fleet, on ``device`` (``None``: CUDA;
    ``"cpu"``: the kernel's plain version).  Reports per-DAG
    planned/predicted/actual max rates and fleet per-VM predicted-vs-actual
    CPU/mem at the planned operating point.

    ``reuse_group_index`` (opt-in) skips rebuilding each entry's
    :class:`GroupIndex` by reusing the one cached on the plan — valid ONLY
    when ``models`` is the library the plan was built with and ``policy``
    is the plan's (the index bakes in per-group capacities and routing
    fractions).  The online controller's repeated between-event
    co-simulations use it; one-off studies should leave it off.
    """
    fracs = (np.asarray(fractions, dtype=float) if fractions is not None
             else np.linspace(0.25, 1.25, 9))
    if len(fracs) == 0:
        raise ValueError("fractions must be non-empty")
    k1 = int(np.argmin(np.abs(fracs - 1.0)))
    policy = policy or fleet.policy
    runnable: List[FleetEntry] = []
    skipped: List[str] = []
    for e in fleet.entries.values():
        if e.schedule is not None and e.omega > 0:
            runnable.append(e)
        else:
            skipped.append(e.name)
    if not runnable:
        raise ValueError("fleet plan has no mapped DAGs to simulate "
                         "(was it planned with mapper=None?)")
    sims = [DataflowSimulator(e.dag, e.schedule.allocation,
                              e.schedule.mapping, _models_for(models, e.name),
                              policy=policy, cpu_penalty=cpu_penalty,
                              gi=(e.group_index if reuse_group_index
                                  and policy is fleet.policy else None))
            for e in runnable]
    batch = SweepBatch(sims)
    omegas_list = [fracs * e.omega for e in runnable]
    raw = batch.sweep_raw(omegas_list, duration=duration, dt=dt,
                          warmup=warmup,
                          latency_sample_every=latency_sample_every,
                          engine=engine, device=device)
    results = batch.results_from_raw(omegas_list, raw)

    entries: Dict[str, FleetSimEntry] = {}
    vm_cpu_p: Dict[int, float] = {}
    vm_mem_p: Dict[int, float] = {}
    vm_cpu_a: Dict[int, float] = {}
    vm_mem_a: Dict[int, float] = {}
    for i, (e, sim) in enumerate(zip(runnable, sims)):
        gi = sim.gi
        stable = [r.omega for r in results[i] if r.stable]
        entries[e.name] = FleetSimEntry(
            name=e.name, omega_planned=e.omega,
            omegas=np.asarray(omegas_list[i]), results=results[i],
            predicted_max_rate=predict_max_rate_gi(gi),
            actual_max_stable=max(stable) if stable else 0.0)
        # §8.5.2 prediction at the SAME operating point the actuals are
        # measured at (fracs[k1] of the planned rate), under the study's
        # policy — so predicted-vs-actual never mixes operating points even
        # when ``fractions`` excludes 1.0
        pred = predict_resources_sweep(gi, [float(fracs[k1]) * e.omega],
                                       mapping=e.schedule.mapping).at(0)
        for vm, c in pred.vm_cpu.items():
            vm_cpu_p[vm] = vm_cpu_p.get(vm, 0.0) + c
        for vm, m in pred.vm_mem.items():
            vm_mem_p[vm] = vm_mem_p.get(vm, 0.0) + m
        # actual draw from the co-simulated served rates at fraction k1:
        # proportional C/M scale-down on each group's mean served rate
        g_lo, g_hi = batch.group_spans[i]
        served_rate = raw.served[g_lo:g_hi, k1] / raw.window
        frac_used = np.where(gi.g_cap > 0,
                             np.minimum(1.0, served_rate /
                                        np.where(gi.g_cap > 0, gi.g_cap, 1.0)),
                             1.0)
        for g in range(gi.n_groups):
            vm = gi.slots[int(gi.g_slot[g])].vm
            vm_cpu_a[vm] = vm_cpu_a.get(vm, 0.0) + gi.g_cpu[g] * frac_used[g]
            vm_mem_a[vm] = vm_mem_a.get(vm, 0.0) + gi.g_mem[g] * frac_used[g]
    slot_busy = {s: float(raw.busy[j, k1] / raw.window)
                 for j, s in enumerate(batch.spec.slots)}
    return FleetSimReport(
        fractions=fracs, at_fraction=float(fracs[k1]), entries=entries,
        skipped=skipped, vm_cpu_predicted=vm_cpu_p, vm_mem_predicted=vm_mem_p,
        vm_cpu_actual=vm_cpu_a, vm_mem_actual=vm_mem_a, slot_busy=slot_busy,
        policy=policy, engine=engine)
