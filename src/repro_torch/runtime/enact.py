"""Live enactment: `FleetController` deltas applied to real executors.

:class:`LiveFleet` closes the planner→executor gap of ROADMAP item 1.  It
wraps a :class:`~repro_torch.core.online.FleetController` and mirrors every
controller delta onto running :class:`~repro_torch.runtime.executor.StreamExecutor`
instances:

* ``DagArrive`` spawns an executor for the new schedule; ``DagDepart``
  retires it;
* a migration delta is applied **in place**: a DAG whose schedule object
  is unchanged (the controller's identity rail) keeps its executor
  untouched — not a single operator is rebound; a remapped DAG is
  :meth:`~repro_torch.runtime.executor.StreamExecutor.rebind`-ed, restarting
  only the slots that actually moved;
* a ``VmFail`` repair (``keep_survivors=True`` redirects each failed
  slot's threads as a unit) becomes a **slot-for-slot transplant**: the
  replacement slot inherits the failed slot's device pin and bound
  operator, surviving slots keep theirs.

After each event the fleet runs a short measurement window per live DAG
(on the shared clock — a :class:`~repro_torch.runtime.stream.VirtualClock` by
default, so replays are deterministic and sleep-free).  Faults from the
:class:`~repro_torch.runtime.chaos.FaultPlan` fire during those windows; when
the executor's circuit breaker trips a VM, :meth:`apply` feeds the
synthetic :class:`~repro_torch.core.online.VmFail` back into the controller,
enacts the repair, and runs a recovery window — the full
detect→escalate→repair→recover loop, inside one event application.

Measured per-task service samples accumulate across windows and feed
:func:`repro_torch.core.calibrate.recalibrate` via :meth:`LiveFleet.measurements`.

A copy of the reference's ``runtime/enact.py``; what differs is
``device``: the fleet runs its executors there (CUDA unless the caller
says ``"cpu"``; without a card that raises) and :meth:`LiveFleet.drift`
co-simulates there (the sweep kernel on the card, its plain version on the
CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple, Union

from ..core.calibrate import (AutoRecalPolicy, CalibrationResult, DriftAlert,
                              TaskMeasurement, detect_drift, rate_error,
                              recalibrate)
from ..core.diagnostics import raise_if_errors, resolve_validate
from ..core.fleet import _models_for
from ..core.online import (ControllerRecord, Event, EventTrace,
                           FleetController, VmFail)
from ..obs import clock as _obs_clock
from ..obs import metrics as _obs_metrics
from ..obs.trace import span as _obs_span
from ..core.perfmodel import ModelLibrary
from ..core.scheduler import Schedule
from ..models.common import DeviceLike, resolve_device
from .chaos import FaultInjector, FaultPlan, FaultTimeline
from .executor import (ExecutionReport, RebindInfo, RobustnessPolicy,
                       StreamExecutor)
from .stream import VirtualClock

TruthArg = Union[None, ModelLibrary, Mapping[str, ModelLibrary]]


def _merge_rebinds(a: RebindInfo, b: RebindInfo) -> RebindInfo:
    """Fold two successive rebinds of one executor (multi-round escalation
    repairs) into one delta record."""
    key = lambda s: (s.vm, s.slot)  # noqa: E731
    restarted = sorted(set(a.restarted_slots) | set(b.restarted_slots),
                       key=key)
    return RebindInfo(
        kept_slots=[s for s in b.kept_slots if s not in set(restarted)],
        restarted_slots=restarted,
        transplanted={**a.transplanted, **b.transplanted},
        reused_ops=a.reused_ops + b.reused_ops,
        fresh_ops=a.fresh_ops + b.fresh_ops)


def transplant_map(old: Schedule, new: Schedule) -> Dict:
    """Failed-slot -> replacement-slot map of a ``keep_survivors`` repair.

    Derived purely from the two mappings: threads whose slot changed must
    have moved *as whole slots* (every thread of one old slot to one new
    slot, the redirect `replan_on_failure` builds) and the old slot must
    be gone from the new schedule.  Any other shape of change (a genuine
    remap) yields ``{}`` — no transplant, moved slots restart normally.
    """
    moves: Dict = {}
    old_assign = old.mapping.assignment
    for thread, new_slot in new.mapping.assignment.items():
        old_slot = old_assign.get(thread)
        if old_slot is None or old_slot == new_slot:
            continue
        if moves.setdefault(old_slot, new_slot) != new_slot:
            return {}          # one old slot scattered to several slots
    if len(set(moves.values())) != len(moves):
        return {}              # two old slots merged into one
    live_new = set(new.mapping.slots())
    return {o: n for o, n in moves.items() if o not in live_new}


@dataclasses.dataclass
class EnactRecord:
    """One event's enactment outcome: controller delta + executor actions
    + measurement windows + any escalation/repair round-trips."""

    time: float
    controller: ControllerRecord
    spawned: List[str]
    retired: List[str]
    untouched: List[str]                 # schedule object identical: no-op
    rebound: Dict[str, RebindInfo]
    reports: Dict[str, ExecutionReport]
    escalations: List[Tuple[str, int]]   # breaker-tripped (dag, vm_id)
    repairs: List[ControllerRecord]      # synthetic VmFail records
    recovery_reports: Dict[str, ExecutionReport]
    drift_magnitude: float = 0.0         # EWMA-damped measured rate error
    drift_alerts: int = 0                # DriftAlerts consumed this event
    recalibration: Optional[ControllerRecord] = None  # ModelRefresh enacted

    @property
    def rates(self) -> Dict[str, float]:
        """Planned rates after the event AND any synthetic repairs."""
        return (self.repairs[-1].rates if self.repairs
                else self.controller.rates)


@dataclasses.dataclass
class EnactmentLog:
    """The fleet's per-event enactment timeline plus the fault record."""

    records: List[EnactRecord] = dataclasses.field(default_factory=list)
    timeline: FaultTimeline = dataclasses.field(default_factory=FaultTimeline)

    def __len__(self) -> int:
        return len(self.records)

    def rates_sequence(self) -> List[Dict[str, float]]:
        """Post-event planned rates, one dict per applied event — directly
        comparable against a headless ``FleetController.replay`` log."""
        return [dict(r.controller.rates) for r in self.records]

    def describe(self) -> str:
        lines = [f"EnactmentLog: {len(self.records)} events, "
                 f"{len(self.timeline)} faults injected"]
        for r in self.records:
            acts = []
            if r.spawned:
                acts.append(f"spawn {','.join(r.spawned)}")
            if r.retired:
                acts.append(f"retire {','.join(r.retired)}")
            if r.rebound:
                acts.append("rebind " + ",".join(
                    f"{n}(+{i.fresh_ops} fresh)" for n, i in r.rebound.items()))
            if r.untouched:
                acts.append(f"untouched {len(r.untouched)}")
            if r.escalations:
                acts.append("escalate " + ",".join(
                    f"{d}:vm{v}" for d, v in r.escalations))
            shed = sum(rep.frames_shed for rep in r.reports.values())
            lines.append(f"  [t={r.time:8.1f}] {r.controller.kind:<10} "
                         f"{'; '.join(acts) or 'no-op'}"
                         + (f", {shed} frames shed" if shed else ""))
        return "\n".join(lines)


class LiveFleet:
    """Executor-backed view of a :class:`FleetController`.

    ``fault_plan`` injects chaos during measurement windows; ``truth`` is
    the model library pricing virtual operator time (per-DAG mapping or
    one shared library — defaults to the controller's planning models, in
    which case measurement reproduces the tables exactly and
    recalibration is a provable no-op); ``frames_per_event`` sizes the
    per-event measurement window (0 disables measurement entirely);
    ``device`` is where the executors run and :meth:`drift` co-simulates.
    """

    def __init__(self, controller: FleetController, *,
                 fault_plan: Optional[FaultPlan] = None,
                 clock=None, truth: TruthArg = None,
                 robustness: Optional[RobustnessPolicy] = None,
                 frames_per_event: int = 8, batch: int = 16,
                 warmup_frames: int = 2, source_seed: int = 0,
                 auto_recal: Optional[AutoRecalPolicy] = None,
                 validate: Optional[bool] = None,
                 device: DeviceLike = None):
        self.ctl = controller
        self.device = resolve_device(device)
        self.plan_faults = (fault_plan if fault_plan is not None
                            else FaultPlan.none())
        self.clock = clock if clock is not None else VirtualClock()
        self.truth = truth
        self.robustness = robustness
        self.frames_per_event = int(frames_per_event)
        self.batch = int(batch)
        self.warmup_frames = int(warmup_frames)
        self.source_seed = int(source_seed)
        self.auto_recal = auto_recal
        self.validate = validate
        self.executors: Dict[str, StreamExecutor] = {}
        self.log = EnactmentLog()
        # closed-loop auto-recalibration state (see AutoRecalPolicy)
        self._drift_ewma = 0.0
        self.recal_ticks: List[int] = []          # log indices of recals
        self.recalibrations: List[CalibrationResult] = []

    # -- helpers ---------------------------------------------------------------
    def _truth_for(self, name: str) -> Optional[ModelLibrary]:
        if self.truth is None or isinstance(self.truth, ModelLibrary):
            return self.truth
        return self.truth.get(name)

    def _spawn(self, name: str, sched: Schedule) -> StreamExecutor:
        injector = None
        if len(self.plan_faults):
            injector = FaultInjector(self.plan_faults, name,
                                     timeline=self.log.timeline)
        return StreamExecutor(
            sched, _models_for(self.ctl.models, name),
            policy=self.ctl.policy, faults=injector,
            robustness=self.robustness, clock=self.clock,
            truth=self._truth_for(name), device=self.device)

    def _sync(self) -> Tuple[List[str], List[str], List[str],
                             Dict[str, RebindInfo]]:
        """Reconcile the executor set with the controller's live entries."""
        spawned: List[str] = []
        retired: List[str] = []
        untouched: List[str] = []
        rebound: Dict[str, RebindInfo] = {}
        live = {n: self.ctl.entry(n) for n in self.ctl.dag_names}
        for name in sorted(self.executors):
            e = live.get(name)
            if e is None or e.schedule is None:
                del self.executors[name]
                retired.append(name)
        for name in sorted(live):
            sched = live[name].schedule
            if sched is None:
                continue
            ex = self.executors.get(name)
            if ex is None:
                self.executors[name] = self._spawn(name, sched)
                spawned.append(name)
            elif ex.schedule is sched:
                # identity rail: rate-unchanged DAG, executor untouched
                untouched.append(name)
            else:
                transplants = transplant_map(ex.schedule, sched)
                with _obs_span("fleet.rebind", dag=name,
                               transplants=len(transplants)):
                    rebound[name] = ex.rebind(sched, transplants=transplants)
        if resolve_validate(self.validate):
            from ..analysis.verify import verify_enactment
            raise_if_errors(verify_enactment(self))
        return spawned, retired, untouched, rebound

    def _measure(self, names=None) -> Dict[str, ExecutionReport]:
        if self.frames_per_event <= 0:
            return {}
        reports: Dict[str, ExecutionReport] = {}
        for name in sorted(names if names is not None else self.executors):
            ex = self.executors.get(name)
            if ex is None:
                continue
            omega = self.ctl.entry(name).omega
            if omega <= 0:
                continue
            reports[name] = ex.run(
                omega, n_frames=self.frames_per_event, batch=self.batch,
                warmup_frames=self.warmup_frames, seed=self.source_seed)
        return reports

    # -- event application -----------------------------------------------------
    def apply(self, event: Event, at: Optional[float] = None) -> EnactRecord:
        """Advance controller + executors by one event, run measurement
        windows, and resolve any breaker escalations to completion.

        The fleet's clock is installed as the telemetry clock for the
        whole tick, so spans recorded anywhere below (controller replans,
        rebinds, executor windows) carry virtual timestamps and two
        replays of one chaos seed produce bit-identical traces."""
        with _obs_clock.use_clock(self.clock), \
                _obs_span("fleet.tick", kind=type(event).__name__):
            return self._apply(event, at)

    def _apply(self, event: Event, at: Optional[float]) -> EnactRecord:
        crec = self.ctl.apply(event, at=at)
        spawned, retired, untouched, rebound = self._sync()
        reports = self._measure()

        escalations: List[Tuple[str, int]] = []
        repairs: List[ControllerRecord] = []
        recovery: Dict[str, ExecutionReport] = {}
        for _ in range(4):   # bounded escalate→repair→re-measure rounds
            pending = [(n, vm) for n in sorted(self.executors)
                       for vm in self.executors[n].take_escalations()]
            if not pending:
                break
            touched: List[str] = []
            for name, vm in pending:
                escalations.append((name, vm))
                repairs.append(self.ctl.apply(VmFail(vm), at=crec.time))
                touched.append(name)
            _, _, _, re_rebound = self._sync()
            for name, info in re_rebound.items():
                prev = rebound.get(name)
                rebound[name] = (info if prev is None
                                 else _merge_rebinds(prev, info))
            recovery.update(self._measure(sorted(set(touched))))

        magnitude, n_alerts, rrec, re_rebound = self._maybe_recalibrate(
            crec, {**reports, **recovery})
        for name, info in re_rebound.items():
            prev = rebound.get(name)
            rebound[name] = (info if prev is None
                             else _merge_rebinds(prev, info))

        record = EnactRecord(
            time=crec.time, controller=crec, spawned=spawned,
            retired=retired, untouched=untouched, rebound=rebound,
            reports=reports, escalations=escalations, repairs=repairs,
            recovery_reports=recovery, drift_magnitude=magnitude,
            drift_alerts=n_alerts, recalibration=rrec)
        self.log.records.append(record)
        if (self.auto_recal is not None and rrec is not None
                and resolve_validate(self.validate)):
            from ..analysis.verify import verify_autorecal
            raise_if_errors(verify_autorecal(self), "LiveFleet.apply")
        return record

    # -- closed-loop auto-recalibration ----------------------------------------
    def _maybe_recalibrate(
            self, crec: ControllerRecord,
            reports: Dict[str, ExecutionReport],
    ) -> Tuple[float, int, Optional[ControllerRecord],
               Dict[str, RebindInfo]]:
        """Consume the fleet's own drift signal; enact a recalibration.

        The per-event measured rate error is EWMA-damped; once the damped
        magnitude crosses the policy threshold (and the cooldown allows),
        the fleet confirms against its :meth:`drift` alert stream and
        folds the measurement window into the planning tables via
        :meth:`FleetController.recalibrate` — a ``ModelRefresh`` event
        that re-levels every rate and rebuilds every schedule.  Executor
        measurement windows reset so the next drift window scores the
        *new* tables."""
        policy = self.auto_recal
        if policy is None or self.frames_per_event <= 0:
            return self._drift_ewma, 0, None, {}
        models = self.ctl.models
        samples = self.measurements()
        if not isinstance(models, ModelLibrary) or not samples:
            return self._drift_ewma, 0, None, {}
        magnitude = rate_error(models, samples)
        s = policy.smoothing
        self._drift_ewma = (1.0 - s) * self._drift_ewma + s * magnitude
        if _obs_metrics.REGISTRY.enabled:
            _obs_metrics.gauge(
                "repro_drift_magnitude",
                "EWMA-damped measured-vs-table rate error.",
                ).set(self._drift_ewma)
        if self._drift_ewma <= policy.threshold:
            return self._drift_ewma, 0, None, {}
        tick = len(self.log.records)     # index of the record being built
        if (self.recal_ticks
                and tick - self.recal_ticks[-1] < policy.cooldown_events):
            if _obs_metrics.REGISTRY.enabled:
                _obs_metrics.counter(
                    "repro_auto_recal_suppressed_total",
                    "Recalibrations withheld by the cooldown.").inc()
            return self._drift_ewma, 0, None, {}
        alerts: List[DriftAlert] = []
        if policy.confirm_with_drift:
            alerts = self.drift(extra_reports=reports)
            if not alerts:
                return self._drift_ewma, 0, None, {}
        result = recalibrate(models, samples, alpha=policy.alpha,
                             validate=self.validate)
        if not result.changed_kinds:
            return self._drift_ewma, len(alerts), None, {}
        with _obs_span("fleet.recalibrate",
                       kinds=",".join(result.changed_kinds)):
            rrec = self.ctl.recalibrate(
                result.library, at=crec.time,
                kinds=result.changed_kinds,
                reason=f"auto: drift {self._drift_ewma:.3f} > "
                       f"{policy.threshold:.3f}")
            _, _, _, re_rebound = self._sync()
        crec.drift_alerts = len(alerts)
        rrec.drift_alerts = len(alerts)
        self.recalibrations.append(result)
        self.recal_ticks.append(tick)
        for name, ex in self.executors.items():
            ex.models = _models_for(self.ctl.models, name)
            ex.reset_measurements()    # next window scores the new tables
        damped = self._drift_ewma
        self._drift_ewma = 0.0
        if _obs_metrics.REGISTRY.enabled:
            # (repro_auto_recalibrations_total is bridged off the rrec
            # ControllerRecord itself, recalibrated=True, at apply time)
            _obs_metrics.counter(
                "repro_drift_alerts_total",
                "DriftAlerts raised by the live fleet.").inc(len(alerts))
        return damped, len(alerts), rrec, re_rebound

    def replay(self, trace: EventTrace) -> EnactmentLog:
        """Enact a whole event trace in time order."""
        for t, event in trace:
            self.apply(event, at=t)
        return self.log

    # -- the measure -> recalibrate loop ---------------------------------------
    def measurements(self) -> List[TaskMeasurement]:
        """All accumulated per-task service samples across live executors."""
        out: List[TaskMeasurement] = []
        for name in sorted(self.executors):
            out.extend(self.executors[name].measurements())
        return out

    def recalibrate(self, *, alpha: float = 0.9,
                    tol: float = 1e-6) -> CalibrationResult:
        """Fold the fleet's measurements back into the planning tables
        (pure: returns the recalibrated library, controller unchanged)."""
        models = self.ctl.models
        if not isinstance(models, ModelLibrary):
            raise TypeError("LiveFleet.recalibrate needs a controller with "
                            "one shared ModelLibrary")
        return recalibrate(models, self.measurements(), alpha=alpha, tol=tol,
                           validate=self.validate)

    def drift(self, extra_reports: Optional[Mapping[str, ExecutionReport]]
              = None, **cosim_kwargs) -> List[DriftAlert]:
        """Compare measured stability (latest reports) against the
        controller's co-simulation verdicts.  ``extra_reports`` lets the
        in-flight event's windows participate before they are logged."""
        latest: Dict[str, ExecutionReport] = {}
        for rec in self.log.records:
            latest.update(rec.reports)
            latest.update(rec.recovery_reports)
        if extra_reports:
            latest.update(extra_reports)
        if not latest or not self.ctl.dag_names:
            return []
        report = self.ctl.cosimulate(**{"device": self.device,
                                        **cosim_kwargs})
        verdicts = {n: e.planned_is_stable
                    for n, e in report.entries.items()}
        return detect_drift(verdicts, latest)
