"""End-to-end schedule planning: model -> allocate -> acquire -> map.

Implements the paper's full pipeline (Fig. 2) with the §8.4 retry rule: when
a resource-aware mapper cannot bin-pack the allocation, acquire one more slot
and retry, reporting both the estimate and the extra slots (the green bars of
Figs. 7-8).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .allocation import ALLOCATORS, Allocation, UnsupportableRateError
from .dag import Dataflow
from .diagnostics import raise_if_errors, resolve_validate
from .mapping import (DEFAULT_VM_SIZES, MAPPERS, PRICE_PER_SLOT_HOUR,
                      InsufficientResourcesError, Mapping, SlotId, VM,
                      VmSizesArg, acquire_vms, pool_cost_per_hour,
                      pool_speed, unit_vm_like, vm_sizes_speed)
from .perfmodel import ModelLibrary
from .predictor import predict_max_rate, predict_resources
from .routing import RoutingPolicy
from ..obs.trace import trace as _obs_trace

#: Give up after this many +1-slot retries (a mapper that cannot place with
#: 4x the estimate is a bug, not fragmentation).
MAX_EXTRA_SLOTS = 512


@dataclasses.dataclass
class Schedule:
    dag: Dataflow
    omega: float
    allocation: Allocation
    vms: List[VM]
    mapping: Mapping
    allocator: str
    mapper: str
    estimated_slots: int     # rho from the allocation
    acquired_slots: int      # slots actually acquired (>= rho on retries)
    #: with ``mapper="search"``: the winning candidate's name (e.g. "sam" or
    #: "rsm[2,1,1]+move3") from the simulation-guided search
    search_winner: Optional[str] = None

    @property
    def extra_slots(self) -> int:
        return self.acquired_slots - self.estimated_slots

    @property
    def price_per_hour(self) -> float:
        """Pool $/hour: class prices when the VMs carry them, the paper's
        slot-proportional §7.1 price otherwise."""
        if self.vms:
            return pool_cost_per_hour(self.vms)
        return self.acquired_slots * PRICE_PER_SLOT_HOUR

    @property
    def pool_speed(self) -> float:
        """The pool's common slot speed (1.0 for the unit-slot baseline or
        when the pool is degenerate/mixed — the verifier flags mixed pools
        with RES_MIXED_SPEED)."""
        speeds = {vm.speed for vm in self.vms}
        return speeds.pop() if len(speeds) == 1 else 1.0

    def predicted_rate(self, models: ModelLibrary,
                       policy: RoutingPolicy = RoutingPolicy.SHUFFLE) -> float:
        return predict_max_rate(self.dag, self.allocation, self.mapping,
                                models, policy)

    def predicted_resources(self, models: ModelLibrary, omega: Optional[float] = None,
                            policy: RoutingPolicy = RoutingPolicy.SHUFFLE):
        return predict_resources(self.dag, self.allocation, self.mapping,
                                 models, omega if omega is not None else self.omega,
                                 policy)

    def describe(self) -> str:
        mapper = (f"{self.mapper}->{self.search_winner}"
                  if self.search_winner else self.mapper)
        lines = [f"Schedule[{self.allocator}+{mapper}] dag={self.dag.name} "
                 f"omega={self.omega:g} slots={self.acquired_slots} "
                 f"(est {self.estimated_slots}, +{self.extra_slots}) "
                 f"threads={self.allocation.total_threads}"]
        for slot, counts in sorted(self.mapping.slot_task_counts().items(),
                                   key=lambda kv: (kv[0].vm, kv[0].slot)):
            desc = ", ".join(f"{t}x{q}" for t, q in sorted(counts.items()))
            lines.append(f"  {slot}: {desc}")
        return "\n".join(lines)


@_obs_trace("plan")
def plan(dag: Dataflow, omega: float, models: ModelLibrary,
         *, allocator: str = "mba", mapper: str = "sam",
         vm_sizes: VmSizesArg = DEFAULT_VM_SIZES,
         fixed_vms: Optional[Sequence[VM]] = None,
         grow_fixed_vms: bool = False,
         allocation: Optional[Allocation] = None,
         search_opts: Optional[Dict] = None,
         validate: Optional[bool] = None) -> Schedule:
    """Plan a schedule for ``dag`` at input rate ``omega``.

    ``fixed_vms`` pins the cluster (the §8.5 five-D3-VM experiments);
    otherwise VMs are acquired per §7.1 for the allocation's slot estimate,
    growing one slot at a time if the mapper reports fragmentation.  With
    ``grow_fixed_vms`` a pinned cluster applies the same §8.4 retry rule by
    appending fresh 1-slot VMs (ids above the pinned set) instead of
    propagating the mapper failure — the fleet planner's per-DAG path, which
    keeps VM ids unique across a shared pool.

    ``mapper="search"`` replaces the single §7 mapper with the
    simulation-guided candidate search (:mod:`repro_torch.core.search`):
    the whole DSM/RSM/SAM + weight-sweep + local-move pool is scored on the
    batched sweep kernel and the empirically best mapping wins (its
    candidate name lands in ``Schedule.search_winner``).  ``search_opts``
    are keyword overrides for :func:`repro_torch.core.search.search_mapping`
    (grids, moves, seeds, policy, engine, ``device``: where the sweeps run,
    CUDA unless it says ``"cpu"``, ...); keys the pipeline owns — pool,
    allocation, allocator, ``vm_sizes`` — are reserved and raise
    ``ValueError``.

    ``vm_sizes`` also accepts :class:`~repro_torch.core.mapping.VmClass`
    objects or a registered family name.  On a ``speed=s`` class the
    allocation is sized at the *effective* rate ``omega / s`` (a thread on a
    speed-``s`` slot serves ``s``× the §6 service rate) while
    ``Schedule.omega`` keeps the real rate; ``s = 1`` reproduces the
    unit-slot plans bit-identically.

    ``allocation`` skips re-allocating when the caller already holds the
    allocation for exactly (``dag``, effective ``omega``, ``allocator``) —
    e.g. the online controller's warm-start path, which allocates once to
    compare thread counts against the incumbent.

    ``validate`` runs the :mod:`repro_torch.analysis` verifier passes (dag,
    allocation, schedule) on the result and raises
    :class:`~repro_torch.core.diagnostics.PlanIntegrityError` on any broken
    invariant; ``None`` defers to the process-wide default
    (:func:`repro_torch.core.diagnostics.default_validate`).
    """
    fixed = fixed_vms is not None
    speed = pool_speed(fixed_vms, default=1.0) if fixed \
        else vm_sizes_speed(vm_sizes)
    # effective rate: omega / 1.0 is bitwise omega, so the unit-slot
    # baseline allocates identically
    alloc = allocation if allocation is not None \
        else ALLOCATORS[allocator](dag, omega / speed, models)
    rho = alloc.slots

    def _checked(sched: Schedule) -> Schedule:
        if resolve_validate(validate):
            from ..analysis.verify import (verify_allocation, verify_dag,
                                          verify_schedule)
            raise_if_errors(verify_dag(dag)
                            + verify_allocation(alloc, dag, models)
                            + verify_schedule(sched), "plan")
        return sched

    if mapper == "search":
        from .search import RESERVED_SEARCH_OPTS, search_mapping
        opts = dict(search_opts or {})
        bad = RESERVED_SEARCH_OPTS & set(opts)
        if bad:
            raise ValueError(f"search_opts may not override {sorted(bad)} "
                             "(owned by the planning pipeline)")
        ranked = search_mapping(
            dag, omega, models, allocator=allocator, allocation=alloc,
            vms=fixed_vms, vm_sizes=vm_sizes,
            grow_pool=(not fixed) or grow_fixed_vms, **opts)
        best = ranked.best
        return _checked(Schedule(
            dag, omega, alloc, list(ranked.vms), best.mapping,
            allocator, "search", estimated_slots=rho,
            acquired_slots=sum(vm.num_slots for vm in ranked.vms),
            search_winner=best.name))

    map_fn = MAPPERS[mapper]

    if fixed and not grow_fixed_vms:
        vms = list(fixed_vms)
        mapping = map_fn(dag, alloc, vms, models)
        return _checked(Schedule(
            dag, omega, alloc, vms, mapping, allocator, mapper,
            estimated_slots=rho,
            acquired_slots=sum(vm.num_slots for vm in vms)))

    # one §8.4 retry loop for both acquisition modes; they differ only in
    # how the next VM list grows by one slot
    vms = list(fixed_vms) if fixed else acquire_vms(rho, vm_sizes)
    last_err: Optional[Exception] = None
    for extra in range(MAX_EXTRA_SLOTS + 1):
        try:
            mapping = map_fn(dag, alloc, vms, models)
        except InsufficientResourcesError as err:
            last_err = err
            if fixed:
                vms = vms + [unit_vm_like(
                    max((vm.id for vm in vms), default=-1) + 1, vms)]
            else:
                vms = acquire_vms(rho + extra + 1, vm_sizes)
            continue
        return _checked(Schedule(
            dag, omega, alloc, vms, mapping, allocator, mapper,
            estimated_slots=rho,
            acquired_slots=sum(vm.num_slots for vm in vms)))
    raise RuntimeError(
        f"mapping failed even with {MAX_EXTRA_SLOTS} extra slots") from last_err


def replan_on_failure(schedule: Schedule, models: ModelLibrary,
                      failed_vm_ids: Sequence[int], *,
                      keep_survivors: bool = False,
                      next_vm_id: Optional[int] = None) -> Schedule:
    """Fault-tolerance / straggler mitigation: rebuild the mapping without
    the failed (or persistently slow) VMs.

    The paper's §2 argument made executable: because allocation is
    model-driven, recovery is ONE deterministic replan — keep the
    allocation (thread counts derive from the models, not the cluster),
    drop the failed VMs, acquire like-for-like replacements (same
    size/class as each failed VM, not re-packed into default §7.1 sizes),
    and re-map.  No incremental trial-and-error convergence.

    ``keep_survivors`` is the migration-minimal variant the online
    controller uses: instead of re-running the mapper over the surviving
    pool (which may shuffle *every* thread), each failed slot's thread
    contents are transplanted as a unit onto a fresh replacement slot.
    Surviving threads keep their exact slots — only threads that were on a
    failed VM move — and the co-location structure (hence the predicted
    rate) is preserved up to VM renaming.

    ``next_vm_id`` floors the replacement (and retry) VM ids: a schedule
    that shares a pool with other DAGs — the fleet controller — must hand
    in its fleet-wide counter, or the per-schedule default
    (``max(own ids) + 1``) could mint ids another DAG already owns.
    """
    failed = set(failed_vm_ids)
    survivors = [vm for vm in schedule.vms if vm.id not in failed]
    failed_vms = [vm for vm in schedule.vms if vm.id in failed]
    # replace like for like (fresh ids beyond the existing ones): each failed
    # VM is cloned size/class/rack-intact, so repairs never silently change
    # the pool shape the original vm_sizes/classes produced
    next_id = max(max((vm.id for vm in schedule.vms), default=-1) + 1,
                  next_vm_id if next_vm_id is not None else 0)
    replacements = [dataclasses.replace(vm, id=next_id + i)
                    for i, vm in enumerate(failed_vms)]
    vms = survivors + replacements

    if keep_survivors:
        rep_slots = [s for vm in replacements for s in vm.slot_ids()]
        redirect: Dict[SlotId, SlotId] = {}
        for thread, slot in schedule.mapping.assignment.items():
            if slot.vm in failed and slot not in redirect:
                # replacement capacity covers the failed VMs' total slots,
                # so every used failed slot gets its own fresh slot
                redirect[slot] = rep_slots[len(redirect)]
        mapping = Mapping(vms)
        for thread, slot in schedule.mapping.assignment.items():
            mapping.assign(thread, redirect.get(slot, slot))
        return Schedule(schedule.dag, schedule.omega, schedule.allocation,
                        vms, mapping, schedule.allocator, schedule.mapper,
                        estimated_slots=schedule.estimated_slots,
                        acquired_slots=sum(vm.num_slots for vm in vms),
                        search_winner=schedule.search_winner)
    last_err: Optional[Exception] = None
    for extra in range(MAX_EXTRA_SLOTS + 1):
        try:
            winner = None
            if schedule.mapper == "search":
                # simulation-guided schedules replan by re-searching the
                # surviving pool (DSM always packs, so this converges)
                from .search import search_mapping
                ranked = search_mapping(
                    schedule.dag, schedule.omega, models,
                    allocator=schedule.allocator,
                    allocation=schedule.allocation, vms=vms, grow_pool=False)
                mapping, winner = ranked.best.mapping, ranked.best.name
            else:
                mapping = MAPPERS[schedule.mapper](
                    schedule.dag, schedule.allocation, vms, models)
            return Schedule(schedule.dag, schedule.omega, schedule.allocation,
                            vms, mapping, schedule.allocator, schedule.mapper,
                            estimated_slots=schedule.estimated_slots,
                            acquired_slots=sum(vm.num_slots for vm in vms),
                            search_winner=winner)
        except InsufficientResourcesError as err:
            last_err = err
            vms = vms + [unit_vm_like(next_id + len(replacements) + extra,
                                      vms)]
    raise RuntimeError("replan failed") from last_err


def max_planned_rate(dag: Dataflow, models: ModelLibrary, *, allocator: str,
                     mapper: str, budget_slots: int,
                     vm_sizes: VmSizesArg = DEFAULT_VM_SIZES,
                     step: float = 10.0, max_rate: float = 1e5,
                     method: str = "bisect",
                     stats: Optional[Dict[str, int]] = None) -> float:
    """Highest rate whose plan fits ``budget_slots`` (the §8.5 protocol:
    'adding incremental input rates of 10 t/s until the resources required is
    just within or equal to' the fixed cluster).

    ``method="bisect"`` (default) evaluates the slot estimate for the WHOLE
    rate grid in one vectorized array pass (:mod:`repro_torch.core.batch`)
    and then bisects the remaining mapper-feasibility oracle — O(log K)
    allocator + mapper calls instead of the paper protocol's O(K)
    trial-and-error scan.
    ``method="scan"`` keeps the literal +``step`` protocol for comparison.
    The scan's stop-at-first-failure semantics are preserved exactly for the
    slot estimate (prefix cut on the vectorized mask); for the residual
    mapper check, bisection assumes feasibility is prefix-monotone on the
    grid — true for the seed models/DAGs (tested exhaustively in
    tests/test_batch.py), though a pathologically fragmented mapper could
    in principle be feasible at a high rate after failing at a lower one,
    where the scan would stop earlier.

    ``stats`` (optional) is filled with ``allocator_calls`` / ``mapper_calls``
    / ``batch_passes`` for instrumentation.
    """
    from .batch import batch_slots, bisect_largest_true, prefix_feasible_count

    counters = stats if stats is not None else {}
    counters.setdefault("allocator_calls", 0)
    counters.setdefault("mapper_calls", 0)
    counters.setdefault("batch_passes", 0)
    speed = vm_sizes_speed(vm_sizes)
    vms = acquire_vms(budget_slots, vm_sizes)

    def plan_fits(omega: float) -> bool:
        counters["allocator_calls"] += 1
        try:
            alloc = ALLOCATORS[allocator](dag, omega / speed, models)
        except UnsupportableRateError:
            # no thread count supports this rate: it cannot fit any budget
            return False
        if alloc.slots > budget_slots:
            return False
        counters["mapper_calls"] += 1
        try:
            MAPPERS[mapper](dag, alloc, vms, models)
        except InsufficientResourcesError:
            return False
        return True

    if method == "scan":
        omega, best = step, 0.0
        while omega <= max_rate:
            if not plan_fits(omega):
                break
            best = omega
            omega += step
        return best
    if method != "bisect":
        raise ValueError(f"unknown max_planned_rate method {method!r}")

    grid = step * np.arange(1, int(max_rate / step) + 1)
    counters["batch_passes"] += 1
    rho_ok = batch_slots(dag, grid, models, allocator,
                         clip_unsupportable=True,
                         speed=speed) <= budget_slots
    # The scan stops at the FIRST rate that does not fit: only the leading
    # all-feasible prefix is eligible, even if a later rate fits again.
    n = prefix_feasible_count(rho_ok)
    if n == 0:
        return 0.0

    def mapper_fits(k: int) -> bool:
        counters["allocator_calls"] += 1
        alloc = ALLOCATORS[allocator](dag, float(grid[k]) / speed, models)
        counters["mapper_calls"] += 1
        try:
            MAPPERS[mapper](dag, alloc, vms, models)
        except InsufficientResourcesError:
            return False
        return True

    best_k = bisect_largest_true(mapper_fits, n)
    return float(grid[best_k]) if best_k >= 0 else 0.0
