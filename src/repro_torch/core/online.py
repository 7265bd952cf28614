"""Online elastic fleet control: event-driven incremental replanning.

:func:`~repro_torch.core.fleet.plan_fleet` answers the *static* fleet question —
but the paper's whole premise is dynamic input: DAGs arrive and depart, VMs
fail, offered load drifts.  This module adds the runtime layer that keeps a
live :class:`~repro_torch.core.fleet.FleetPlan` current without ever replanning
the whole fleet from scratch.

Event model
-----------
A fleet changes through five typed events, replayed from an
:class:`EventTrace` (a time-ordered ``(time, event)`` sequence) or applied
one at a time with :meth:`FleetController.apply`:

``DagArrive``   a new dataflow asks for admission (weight / priority /
                optional offered-load ceiling).  This is the ONLY event
                that computes a new slot surface — one
                :func:`~repro_torch.core.batch.batch_slots` grid pass, cached in
                the controller's :class:`~repro_torch.core.fleet.SlotSurfaceCache`
                for the DAG's lifetime.  An arrival that cannot fit the
                budget even at the grid's floor rate is rejected with
                :class:`~repro_torch.core.fleet.UnsupportableDagError` (naming
                the DAG) and leaves the fleet untouched.
``DagDepart``   a dataflow leaves; its surface is dropped and its VMs are
                released.  Freed budget water-fills to the remaining DAGs.
``VmFail``      one VM dies.  Planned rates are unchanged (replacement
                capacity is re-acquired per §7.1); the owning DAG's
                schedule is repaired with
                ``replan_on_failure(keep_survivors=True)`` — each failed
                slot's threads transplant as a unit onto a fresh slot, so
                ONLY threads that sat on the failed VM move.
``VmAdd``       the cluster grows by N slots; the extra budget water-fills
                across the fleet.
``RateChange``  a DAG's offered load changed: its planned rate is capped at
                the new ceiling (``None`` removes the cap), releasing — or
                reclaiming — budget for the rest of the fleet.
``ModelRefresh`` the planning tables were replaced (recalibration from
                measured rates, see :mod:`repro_torch.core.calibrate`):
                every live DAG's slot surface is recomputed against the new
                models and every schedule is rebuilt on its incumbent VMs.
                :meth:`FleetController.recalibrate` is the usual entry
                point; ``LiveFleet`` (:mod:`repro_torch.runtime.enact`)
                fires it automatically from its own ``DriftAlert`` stream
                when given an ``AutoRecalPolicy``.

Incremental replanning
----------------------
On every event the controller re-runs ONLY the joint level bisection +
water-fill (:func:`~repro_torch.core.fleet.replan_incremental`) over the cached
per-DAG ``(rate x slots)`` surfaces — pure array probes, zero allocator
calls — producing rates *identical* to a full ``plan_fleet`` of the same
DAG set, budget, and objective.

Delta semantics
---------------
The new rates are applied as a migration-cost-aware diff against the live
per-DAG :class:`~repro_torch.core.scheduler.Schedule`\\ s:

* a DAG whose planned rate is unchanged (and whose VMs did not fail) keeps
  its ``Schedule`` object — mappings stay bit-identical, zero threads move
  (:func:`~repro_torch.core.mapping.mapping_signature` is the invariance
  contract the tests pin);
* a DAG whose rate changed is re-planned *on its own incumbent VMs* (grown
  with fresh fleet-unique VMs only when the new slot estimate outgrows
  them, trimmed of VMs left empty when it shrinks), so churn stays inside
  the DAG that changed;
* with ``mapper="search"`` the incumbent mapping is passed to
  :func:`~repro_torch.core.search.search_mapping` as a warm-start candidate
  whenever the new allocation keeps the thread set, so a replan can only
  beat the incumbent, never regress to a worse mapping;
* threads migrated are counted as threads present before AND after whose
  slot changed — a full replan re-acquires every VM and moves everything,
  the incremental path moves only the delta
  (``benchmarks/bench_online.py`` quantifies both).

Self-sizing fleets
------------------
``FleetController(self_size=True)`` drops the externally-owned slot budget.
Every arrival must pin a demand ceiling (``max_rate``); after each event the
controller re-sizes its own budget to exactly the slots needed to serve every
live DAG at its ceiling — acquiring VMs from its class family
(:class:`~repro_torch.core.mapping.VmClass`) on growth and releasing emptied VMs on
departs and rate drops, so fleet $/hour tracks demand in both directions.
Each :class:`ControllerRecord` logs the acquired pool's
``fleet_cost_per_hour``, giving the dollar timeline of an elastic fleet.

Between events :meth:`FleetController.cosimulate` closes the loop
empirically: the live fleet co-simulates in ONE batched
``SweepBatch``/:func:`~repro_torch.core.fleet.simulate_fleet` pass (one
launch of the sweep kernel, reusing each entry's cached ``GroupIndex`` and
the module-level cache of packed sweep structures) and the per-event
:class:`ControllerRecord` logs predicted-vs-planned stability next to
planned rates, slots moved, threads migrated, and replan latency — the
:class:`ControllerLog` timeline.

A copy of the JAX package's ``core/online.py``.  Besides the module
references, one thing differs: :meth:`FleetController.cosimulate` takes
``device``, where the ``"scan"`` engine runs (``None``: the CUDA sweep
kernel, which raises without a card; ``"cpu"``: its plain PyTorch
version), and passes it on to :func:`~repro_torch.core.fleet.
simulate_fleet`; ``replay(simulate=True, device=...)`` passes it through.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .allocation import ALLOCATORS
from .dag import Dataflow
from .diagnostics import raise_if_errors, resolve_validate
from .fleet import (FleetEntry, FleetPlan, FleetSimEntry, FleetSimReport,
                    ModelsArg, SlotSurfaceCache, UnsupportableDagError,
                    _models_for, replan_incremental, simulate_fleet)
from .mapping import (DEFAULT_VM_SIZES, InsufficientResourcesError,
                      Mapping as ThreadMapping, VM, VmClass, VmSizesArg,
                      acquire_vms, pool_cost_per_hour, resolve_vm_classes,
                      unit_vm_like, vm_sizes_speed)
from .predictor import (build_group_index, predict_max_rate_gi,
                        predict_resources_sweep)
from .routing import RoutingPolicy
from .scheduler import MAX_EXTRA_SLOTS, Schedule, plan, replan_on_failure
from ..models.common import DeviceLike
from ..obs import metrics as _obs_metrics
from ..obs.trace import span as _obs_span


# ---------------------------------------------------------------------------
# Events.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DagArrive:
    """A new dataflow asks for admission to the fleet."""

    name: str
    dag: Dataflow
    weight: float = 1.0
    priority: int = 0
    max_rate: Optional[float] = None    # offered-load ceiling (t/s)


@dataclasses.dataclass(frozen=True)
class DagDepart:
    name: str


@dataclasses.dataclass(frozen=True)
class VmFail:
    vm_id: int


@dataclasses.dataclass(frozen=True)
class VmAdd:
    slots: int                          # budget grows by this many slots


@dataclasses.dataclass(frozen=True)
class RateChange:
    """A DAG's offered load changed; ``max_rate=None`` removes the cap."""

    name: str
    max_rate: Optional[float]


@dataclasses.dataclass(frozen=True)
class ModelRefresh:
    """The planning tables were replaced (model recalibration).

    Every live DAG's slot surface is recomputed against the controller's
    *current* ``models`` and every schedule rebuilt on its incumbent VMs;
    rates re-level exactly as any other event.  ``kinds`` names the task
    kinds whose tables actually changed (informational, for the log)."""

    kinds: Tuple[str, ...] = ()
    reason: str = ""


Event = Union[DagArrive, DagDepart, VmFail, VmAdd, RateChange, ModelRefresh]


@dataclasses.dataclass
class EventTrace:
    """A time-ordered ``(time, event)`` sequence (sorted stably on build,
    so same-time events keep their authored order)."""

    events: List[Tuple[float, Event]]

    def __post_init__(self) -> None:
        self.events = sorted(self.events, key=lambda te: te[0])

    def __iter__(self) -> Iterator[Tuple[float, Event]]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)


# ---------------------------------------------------------------------------
# The controller log.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ControllerRecord:
    """One event's outcome: what was replanned, what moved, what it cost."""

    time: float
    event: Event
    rates: Dict[str, float]          # planned rate per live DAG, post-event
    changed: List[str]               # DAGs rescheduled / repaired
    threads_migrated: int            # pre-existing threads whose slot moved
    threads_total: int               # mapped threads across the fleet
    slots_moved: int                 # sum over DAGs of |delta est. slots|
    batch_passes: int                # new slot surfaces computed (arrivals)
    replan_latency_s: float          # wall time of the whole apply()
    stable: Optional[Dict[str, bool]] = None   # co-sim verdict per DAG
    fleet_cost_per_hour: float = 0.0  # $/hour of the acquired pool, post-event
    drift_alerts: int = 0            # DriftAlerts consumed at this event
    recalibrated: bool = False       # event was a ModelRefresh (recal enacted)

    @property
    def kind(self) -> str:
        return type(self.event).__name__


@dataclasses.dataclass
class ControllerLog:
    """The controller's per-event timeline."""

    records: List[ControllerRecord] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.records)

    def describe(self) -> str:
        lines = [f"ControllerLog: {len(self.records)} events"]
        for r in self.records:
            rates = ", ".join(f"{n}={w:g}" for n, w in r.rates.items())
            sim = ""
            if r.stable is not None:
                bad = [n for n, ok in r.stable.items() if not ok]
                sim = (" sim=OK" if not bad
                       else f" sim=MISSES{bad}")
            lines.append(
                f"  [t={r.time:8.1f}] {r.kind:<10} rates[{rates}] "
                f"moved {r.threads_migrated}/{r.threads_total} threads, "
                f"{r.slots_moved} slots, {r.batch_passes} surface pass"
                f"{'es' if r.batch_passes != 1 else ''}, "
                f"${r.fleet_cost_per_hour:.3f}/h, "
                f"{r.replan_latency_s * 1e3:.1f} ms{sim}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The controller.
# ---------------------------------------------------------------------------

class FleetController:
    """Event-driven elastic fleet controller over cached slot surfaces.

    Holds the live fleet state — per-DAG surfaces
    (:class:`~repro_torch.core.fleet.SlotSurfaceCache`), weights / priorities /
    demand ceilings, the slot budget, and one
    :class:`~repro_torch.core.fleet.FleetEntry` (schedule + prediction +
    ``GroupIndex``) per mapped DAG.  :meth:`apply` advances the fleet by
    one event; :meth:`replay` drives a whole :class:`EventTrace`;
    :attr:`plan` materializes the current state as an ordinary
    :class:`~repro_torch.core.fleet.FleetPlan` (so every existing fleet report /
    simulation entry point works on the live fleet); :meth:`cosimulate`
    runs the batched predicted-vs-planned check between events.

    ``mapper=None`` runs a rates-only controller (no VM pool, no thread
    mappings) — the pure array path used by the parity tests.
    """

    def __init__(self, models: ModelsArg, *,
                 budget_slots: Optional[int] = None,
                 objective: str = "max_min", allocator: str = "mba",
                 mapper: Optional[str] = "sam", step: float = 10.0,
                 max_rate: float = 1e4,
                 vm_sizes: VmSizesArg = DEFAULT_VM_SIZES,
                 self_size: bool = False,
                 policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
                 warm_start_search: bool = True,
                 search_opts: Optional[Dict] = None,
                 validate: Optional[bool] = None):
        if self_size:
            if budget_slots is not None:
                raise ValueError(
                    "a self-sizing controller owns its budget; "
                    "do not pass budget_slots")
        elif budget_slots is None:
            raise ValueError(
                "budget_slots is required unless self_size=True")
        elif budget_slots <= 0:
            raise ValueError("budget_slots must be positive")
        self.models = models
        #: tri-state: True/False force verification per apply(); None
        #: defers to the process-wide default (see repro_torch.core.diagnostics)
        self.validate = validate
        self.objective = objective
        self.allocator = allocator
        self.mapper = mapper
        self.vm_sizes = (vm_sizes if isinstance(vm_sizes, str)
                         else tuple(vm_sizes))
        #: acquire-to-demand mode: the controller sizes its own slot budget
        #: to cover every live DAG's pinned demand ceiling, growing on
        #: arrivals / rate rises and releasing capacity on departs / drops
        self.self_size = bool(self_size)
        # per-DAG pools are single-speed (mapping.acquire_vms enforces it),
        # so one uniform speed / mem quantum governs the whole controller
        self._speed = vm_sizes_speed(self.vm_sizes)
        mems = {c.mem_per_slot for c in resolve_vm_classes(self.vm_sizes)}
        if len(mems) > 1:
            raise ValueError(
                "controller vm_sizes must share one mem_per_slot; "
                "mixed-memory fleets need plan_fleet(objective='min_cost')")
        self._mem_per_slot = mems.pop()
        self.policy = policy
        self.budget_slots = 1 if self_size else int(budget_slots)
        self.warm_start_search = warm_start_search
        self.search_opts = dict(search_opts or {})
        surf = None
        if self._speed != 1.0 or self._mem_per_slot != 1.0:
            surf = VmClass("_controller", 1, speed=self._speed,
                           mem_per_slot=self._mem_per_slot)
        self.cache = SlotSurfaceCache(allocator=allocator, step=step,
                                      max_rate=max_rate, surface_class=surf)
        self.log = ControllerLog()
        self.clock = 0.0
        self._dags: Dict[str, Dataflow] = {}
        self._weights: Dict[str, float] = {}
        self._priorities: Dict[str, int] = {}
        self._max_rates: Dict[str, float] = {}
        self._entries: Dict[str, FleetEntry] = {}
        self._next_vm_id = 0

    # -- views ---------------------------------------------------------------
    @property
    def dag_names(self) -> List[str]:
        return list(self._dags)

    def entry(self, name: str) -> FleetEntry:
        return self._entries[name]

    @property
    def pool(self) -> List[VM]:
        return [vm for e in self._entries.values() if e.schedule
                for vm in e.schedule.vms]

    @property
    def plan(self) -> FleetPlan:
        """The live fleet as an ordinary :class:`FleetPlan` snapshot."""
        names = list(self._dags)
        slots = (np.stack([self.cache.row(n) for n in names]) if names
                 else np.zeros((0, len(self.cache.grid)), dtype=np.int64))
        pool = self.pool
        return FleetPlan(
            objective=self.objective, budget_slots=self.budget_slots,
            grid=self.cache.grid, slots_matrix=slots,
            entries={n: self._entries[n] for n in names},
            pool=pool,
            overflow_slots=max(0, sum(vm.num_slots for vm in pool)
                               - self.budget_slots),
            policy=self.policy)

    # -- event application ----------------------------------------------------
    def apply(self, event: Event, at: Optional[float] = None
              ) -> ControllerRecord:
        """Advance the fleet by one event and log the outcome.

        Rates are re-selected incrementally over the cached surfaces and
        applied as a delta against the live schedules (see the module
        docstring).  A rejected arrival (:class:`UnsupportableDagError`)
        raises AND leaves the controller state exactly as before.
        """
        with _obs_span("controller.apply", kind=type(event).__name__):
            return self._apply(event, at)

    def _apply(self, event: Event, at: Optional[float]) -> ControllerRecord:
        t0 = time.perf_counter()
        if self.self_size:
            # demand ceilings ARE the budget signal: every live DAG must
            # keep one pinned, and nobody else hands the controller slots
            if isinstance(event, VmAdd):
                raise ValueError(
                    "VmAdd does not apply to a self-sizing controller "
                    "(it owns its budget)")
            if isinstance(event, DagArrive) and event.max_rate is None:
                raise ValueError(
                    "a self-sizing controller admits only DAGs with a "
                    "demand ceiling (max_rate)")
            if isinstance(event, RateChange) and event.max_rate is None:
                raise ValueError(
                    "a self-sizing controller cannot unpin a demand "
                    "ceiling (RateChange(max_rate=None))")
        prev_clock = self.clock
        self.clock = self.clock if at is None else float(at)
        passes0 = self.cache.stats["batch_passes"]
        failed_vm: Optional[int] = None

        if isinstance(event, DagArrive):
            if event.name in self._dags:
                raise ValueError(f"DAG {event.name!r} already in the fleet")
            lib = _models_for(self.models, event.name)
            # the ONE place a new slot surface is ever computed
            self.cache.surface(event.name, event.dag, lib)
            self._dags[event.name] = event.dag
            self._weights[event.name] = float(event.weight)
            self._priorities[event.name] = int(event.priority)
            if event.max_rate is not None:
                self._max_rates[event.name] = float(event.max_rate)
        elif isinstance(event, DagDepart):
            if event.name not in self._dags:
                raise ValueError(f"unknown DAG {event.name!r}")
            self._evict(event.name)
        elif isinstance(event, RateChange):
            if event.name not in self._dags:
                raise ValueError(f"unknown DAG {event.name!r}")
            if event.max_rate is None:
                self._max_rates.pop(event.name, None)
            else:
                self._max_rates[event.name] = float(event.max_rate)
        elif isinstance(event, VmAdd):
            if event.slots <= 0:
                raise ValueError("VmAdd.slots must be positive")
            self.budget_slots += int(event.slots)
        elif isinstance(event, VmFail):
            # tolerate a failure notice for an already-released VM (a
            # depart racing the notice): it is a recorded no-op
            failed_vm = int(event.vm_id)
        elif isinstance(event, ModelRefresh):
            # new tables invalidate every cached surface: recompute them
            # all (each counts as a batch pass in the record)
            for name in list(self._dags):
                self.cache.drop(name)
                self.cache.surface(name, self._dags[name],
                                   _models_for(self.models, name))
        else:
            raise TypeError(f"unknown fleet event {event!r}")

        if self.self_size:
            self.budget_slots = self._self_sized_budget()

        names = list(self._dags)
        try:
            decisions = replan_incremental(
                self.cache, names, budget_slots=self.budget_slots,
                objective=self.objective, weights=self._weights,
                priorities=self._priorities, max_rates=self._max_rates,
                validate=False)   # apply() verifies whole-state below
        except UnsupportableDagError:
            if isinstance(event, DagArrive):
                self._evict(event.name)   # reject: fleet state unchanged
                if self.self_size:
                    self.budget_slots = self._self_sized_budget()
                self.clock = prev_clock
            raise

        changed: List[str] = []
        migrated = 0
        slots_moved = 0
        refreshed = isinstance(event, ModelRefresh)
        new_entries: Dict[str, FleetEntry] = {}
        for name in names:
            dec = decisions[name]
            old = self._entries.get(name)
            hit_by_fail = (failed_vm is not None and old is not None
                           and old.schedule is not None
                           and any(vm.id == failed_vm
                                   for vm in old.schedule.vms))
            if (old is not None and old.omega == dec.omega
                    and not hit_by_fail and not refreshed):
                new_entries[name] = old      # untouched: bit-identical
                continue
            lib = _models_for(self.models, name)
            old_sched = old.schedule if old is not None else None
            if hit_by_fail and old.omega == dec.omega:
                sched = replan_on_failure(old_sched, lib, [failed_vm],
                                          keep_survivors=True,
                                          next_vm_id=self._next_vm_id)
            else:
                if hit_by_fail:
                    # unreachable today (a failure changes no rate input),
                    # but if rates ever shift in the same event the
                    # rebuild must not land threads back on dead hardware
                    old_sched = dataclasses.replace(
                        old_sched, vms=[vm for vm in old_sched.vms
                                        if vm.id != failed_vm])
                sched = self._reschedule(name, dec.omega,
                                         dec.estimated_slots, old_sched, lib)
            new_entries[name] = self._build_entry(name, dec, sched, lib)
            changed.append(name)
            migrated += _threads_moved(old_sched, sched)
            slots_moved += abs(dec.estimated_slots -
                               (old.estimated_slots if old else 0))
            if sched is not None:
                self._next_vm_id = max(self._next_vm_id,
                                       max(vm.id for vm in sched.vms) + 1)
        for name, old in self._entries.items():
            if name not in self._dags:       # departed: count the teardown
                slots_moved += old.estimated_slots
        self._entries = new_entries

        record = ControllerRecord(
            time=self.clock, event=event,
            rates={n: decisions[n].omega for n in names},
            changed=changed, threads_migrated=migrated,
            threads_total=sum(
                len(e.schedule.mapping.assignment)
                for e in new_entries.values() if e.schedule),
            slots_moved=slots_moved,
            batch_passes=self.cache.stats["batch_passes"] - passes0,
            replan_latency_s=time.perf_counter() - t0,
            fleet_cost_per_hour=pool_cost_per_hour(self.pool),
            recalibrated=refreshed)
        self.log.records.append(record)
        if _obs_metrics.REGISTRY.enabled:
            _obs_metrics.observe_controller_record(record)
        if resolve_validate(self.validate):
            # O(changed): untouched entries skip their schedule walks
            from ..analysis.verify import verify_controller
            raise_if_errors(verify_controller(self, changed=changed),
                            f"FleetController.apply({type(event).__name__})")
        return record

    def recalibrate(self, library: ModelsArg, *,
                    at: Optional[float] = None,
                    kinds: Sequence[str] = (),
                    reason: str = "") -> ControllerRecord:
        """Install recalibrated planning tables and refresh the fleet.

        Swaps ``self.models`` for ``library`` (any :data:`ModelsArg`
        form), then applies a :class:`ModelRefresh` event so every cached
        slot surface is recomputed and every schedule rebuilt against the
        new tables.  Returns that event's :class:`ControllerRecord`
        (``recalibrated=True``)."""
        self.models = library
        return self.apply(ModelRefresh(kinds=tuple(kinds), reason=reason),
                          at=at)

    def replay(self, trace: EventTrace, *, simulate: bool = False,
               **sim_kwargs) -> ControllerLog:
        """Apply a whole trace in time order; with ``simulate`` each event
        is followed by a :meth:`cosimulate` pass whose per-DAG stability
        verdicts land in the record's ``stable`` field."""
        for t, event in trace:
            record = self.apply(event, at=t)
            if simulate and any(e.schedule for e in self._entries.values()):
                report = self.cosimulate(**sim_kwargs)
                record.stable = {n: e.planned_is_stable
                                 for n, e in report.entries.items()}
        return self.log

    def cosimulate(self, *, fractions: Optional[Sequence[float]] = None,
                   duration: float = 8.0, dt: float = 0.1,
                   warmup: float = 2.0, latency_sample_every: float = 0.25,
                   engine: str = "scan", prove: bool = False,
                   device: DeviceLike = None) -> FleetSimReport:
        """Predicted-vs-planned check of the live fleet: one batched
        co-simulation over the union VM pool (the entries' cached
        ``GroupIndex`` and the module-level cache of packed sweep
        structures make repeated controller steps rebuild nothing), on
        ``device`` (``None``: the CUDA sweep kernel; ``"cpu"``: its plain
        version).

        With ``prove=True`` the static rate-stability prover
        (:mod:`repro_torch.analysis.prove`, §6 recurrence vs §8.4.1 capacity over
        interval arithmetic) runs first; entries whose every sweep cell is
        decided (proved stable or proved unstable) skip the simulator
        entirely and come back as synthetic :class:`FleetSimEntry` rows with
        ``proved`` set and ``results=[]``.  Only the unprovable remainder is
        simulated.  When nothing needs simulating the report's ``engine`` is
        ``"proved"``."""
        if not prove:
            return simulate_fleet(
                self.plan, self.models, fractions=fractions, duration=duration,
                dt=dt, warmup=warmup,
                latency_sample_every=latency_sample_every,
                engine=engine, reuse_group_index=True, device=device)

        from ..analysis.prove import PROVED_STABLE, prove_fleet

        fracs = (np.linspace(0.25, 1.25, 9) if fractions is None
                 else np.asarray(list(fractions), dtype=np.float64))
        k1 = int(np.argmin(np.abs(fracs - 1.0)))
        proofs = prove_fleet(self.plan, self.models, fractions=fracs)

        proved_entries: Dict[str, FleetSimEntry] = {}
        rest: List[FleetEntry] = []
        for e in self.plan.entries.values():
            prs = proofs.get(e.name)
            if (prs is not None and e.group_index is not None
                    and all(p.proved for p in prs)):
                stable = [p.omega for p in prs if p.verdict == PROVED_STABLE]
                proved_entries[e.name] = FleetSimEntry(
                    name=e.name, omega_planned=e.omega,
                    omegas=np.asarray([p.omega for p in prs]), results=[],
                    predicted_max_rate=predict_max_rate_gi(e.group_index),
                    actual_max_stable=max(stable) if stable else 0.0,
                    proved=prs[k1].verdict)
            else:
                rest.append(e)

        if any(e.schedule is not None and e.omega > 0 for e in rest):
            report = simulate_fleet(
                dataclasses.replace(self.plan,
                                    entries={e.name: e for e in rest}),
                self.models,
                fractions=fracs, duration=duration, dt=dt, warmup=warmup,
                latency_sample_every=latency_sample_every,
                engine=engine, reuse_group_index=True, device=device)
        else:
            report = FleetSimReport(
                fractions=fracs, at_fraction=float(fracs[k1]), entries={},
                skipped=[e.name for e in rest],
                vm_cpu_predicted={}, vm_mem_predicted={},
                vm_cpu_actual={}, vm_mem_actual={}, slot_busy={},
                policy=self.plan.policy, engine="proved")
        report.entries.update(proved_entries)
        return report

    # -- internals -----------------------------------------------------------
    def _self_sized_budget(self) -> int:
        """Slots needed to serve every live DAG at its pinned demand
        ceiling — the acquire-to-demand budget.  Reads only cached surface
        rows, so it costs a few array probes per DAG; grid cells clipped as
        unsupportable (the 2**62 sentinel) fall back to the last
        supportable rate at or below the ceiling."""
        grid = self.cache.grid
        total = 0
        for name in self._dags:
            row = self.cache.row(name)
            ceiling = self._max_rates[name]
            k = int(np.searchsorted(grid, ceiling * (1 + 1e-12),
                                    side="right")) - 1
            while k >= 0 and float(row[k]) >= 2.0 ** 61:
                k -= 1
            if k >= 0:
                total += int(row[k])
        return max(total, 1)

    def _evict(self, name: str) -> None:
        self._dags.pop(name, None)
        self._weights.pop(name, None)
        self._priorities.pop(name, None)
        self._max_rates.pop(name, None)
        self.cache.drop(name)

    def _reschedule(self, name: str, omega: float, est_slots: int,
                    old_sched: Optional[Schedule], lib) -> Optional[Schedule]:
        """Re-plan one DAG at a new rate on (a minimal extension of) its
        incumbent VMs; fresh VMs take fleet-unique ids from the controller's
        counter, and VMs left empty by the new mapping are released."""
        if omega <= 0 or self.mapper is None:
            return None
        base = list(old_sched.vms) if old_sched is not None else []
        have = sum(vm.num_slots for vm in base)
        if est_slots > have:
            fresh = acquire_vms(est_slots - have, self.vm_sizes)
            base = base + [dataclasses.replace(vm, id=self._next_vm_id + i)
                           for i, vm in enumerate(fresh)]
            self._next_vm_id += len(fresh)
        search_opts = dict(self.search_opts) or None
        alloc = None
        if (self.mapper == "search" and self.warm_start_search
                and old_sched is not None):
            # allocate once up front (plan() reuses it below) to check the
            # incumbent mapping still covers the new thread set
            alloc = ALLOCATORS[self.allocator](self._dags[name],
                                               omega / self._speed, lib)
            same_threads = {n: ta.threads for n, ta in alloc.tasks.items()} \
                == {n: ta.threads
                    for n, ta in old_sched.allocation.tasks.items()}
            on_pool = {s.vm for s in
                       old_sched.mapping.assignment.values()} \
                <= {vm.id for vm in base}
            if same_threads and on_pool:
                search_opts = dict(self.search_opts)
                search_opts["extra_candidates"] = {
                    "incumbent": old_sched.mapping}
        # §8.4 growth with controller-owned ids: plan()'s own retry loop
        # appends ids just above the DAG's subset, which could collide with
        # another DAG's VMs — so the retries run here, on the global counter
        vms = base
        for _ in range(MAX_EXTRA_SLOTS + 1):
            try:
                return plan(self._dags[name], omega, lib,
                            allocator=self.allocator, mapper=self.mapper,
                            fixed_vms=vms, grow_fixed_vms=False,
                            allocation=alloc, search_opts=search_opts)
            except InsufficientResourcesError:
                vms = vms + [unit_vm_like(self._next_vm_id, vms)]
                self._next_vm_id += 1
        raise RuntimeError(
            f"mapping {name!r} failed even with {MAX_EXTRA_SLOTS} extra "
            "slots")

    def _build_entry(self, name: str, dec, sched: Optional[Schedule],
                     lib) -> FleetEntry:
        gi = prediction = None
        if sched is not None:
            sched = _trim_empty_vms(sched)
            gi = build_group_index(self._dags[name], sched.allocation,
                                   sched.mapping, lib, self.policy)
            prediction = predict_resources_sweep(
                gi, [dec.omega], mapping=sched.mapping).at(0)
        return FleetEntry(
            name=name, dag=self._dags[name], weight=self._weights[name],
            priority=self._priorities[name], omega=dec.omega,
            grid_index=dec.grid_index, estimated_slots=dec.estimated_slots,
            schedule=sched, prediction=prediction, group_index=gi)


# ---------------------------------------------------------------------------
# Delta helpers.
# ---------------------------------------------------------------------------

def _threads_moved(old: Optional[Schedule], new: Optional[Schedule]) -> int:
    """Threads present before AND after whose slot changed — the migration
    cost of a replan (appearing/disappearing threads are spin-up/teardown,
    not migrations)."""
    if old is None or new is None:
        return 0
    old_a = old.mapping.assignment
    return sum(1 for t, s in new.mapping.assignment.items()
               if t in old_a and old_a[t] != s)


def _trim_empty_vms(sched: Schedule) -> Schedule:
    """Release VMs the mapping left entirely empty (a shrunk DAG keeps its
    incumbent pool for the remap, then gives back what it no longer uses).
    The mapping is rebuilt on the kept VMs so schedule, mapping, and
    prediction agree on the DAG's VM inventory."""
    used = {s.vm for s in sched.mapping.assignment.values()}
    kept = [vm for vm in sched.vms if vm.id in used]
    if len(kept) == len(sched.vms):
        return sched
    mapping = ThreadMapping(kept)
    for thread, slot in sched.mapping.assignment.items():
        mapping.assign(thread, slot)
    return dataclasses.replace(
        sched, vms=kept, mapping=mapping,
        acquired_slots=sum(vm.num_slots for vm in kept))
