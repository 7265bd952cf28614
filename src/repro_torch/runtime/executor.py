"""Streaming executor: enacts a planned Schedule on the card.

Each resource *slot* of the schedule is pinned to a device (slot k ->
``cuda:{k % n}`` over the n visible cards, or the CPU when the caller asks
for it), so a multi-VM schedule runs with the same thread->slot structure
the mapper produced.  Tuples flow as micro-batch frames in DAG topological
order; at each task the frame is routed over the task's per-slot thread
groups (shuffle = thread-proportional, slot-aware = capacity-proportional),
processed by the slot-pinned operator (one CUDA kernel launch a part,
:mod:`repro_torch.kernels.stream_ops`), and the results interleave
downstream — the Storm execution model of §2.

Robustness machinery (the chaos-hardened enactment layer):

* **per-frame operator retry** — a failing operator attempt is retried with
  exponential backoff up to :attr:`RobustnessPolicy.max_retries` times,
  bounded by the frame deadline;
* **frame-timeout watchdog** — a frame whose processing (stalls included)
  exceeds :attr:`RobustnessPolicy.frame_deadline_intervals` × the frame
  interval is abandoned and counted, so one wedged operator cannot hang the
  run;
* **load shedding** — a frame arriving when the executor is already behind
  by more than :attr:`RobustnessPolicy.shed_backlog_frames` frames is shed
  (graceful degradation instead of unbounded queue growth);
* **circuit breaker** — a slot failing :attr:`RobustnessPolicy.breaker_threshold`
  consecutive frames trips its VM: the VM's parts are skipped and the id is
  queued for escalation (:meth:`StreamExecutor.take_escalations`) so the
  enactment layer can feed a synthetic ``VmFail`` back to the controller.

Faults are injected between routing and the operator invocation via an
optional :class:`~repro_torch.runtime.chaos.FaultInjector`.  Timing runs on a
pluggable clock (:mod:`repro_torch.runtime.stream`): under a
:class:`~repro_torch.runtime.stream.VirtualClock`, operator costs come from
the performance-model tables (``truth`` — the measured "ground truth"
library), which makes whole chaos replays deterministic and sleep-free.

Measured per-(task, slot-group) service rates accumulate in the executor
and feed :mod:`repro_torch.core.calibrate` — the measure→recalibrate loop.

A copy of the reference's ``runtime/executor.py``; what differs:

* slots are pinned to torch devices (``device=``), and two pins are
  the same device when they compare equal (``torch.device`` objects are
  not singletons, JAX's devices are);
* under a :class:`~repro_torch.runtime.stream.WallClock` an operator's
  busy time is read after its outputs are ready (a synchronisation on the
  slot's device): a launch returns before its kernel ends, and without it
  :meth:`StreamExecutor.measurements` would price launches, not work;
* a frame completes on a synchronisation of its sink output's device, and
  parts gather to one device with ``.to`` and ``torch.cat``;
* :attr:`StreamExecutor.invocations` counts operator calls by kind.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.dag import Dataflow, Routing
from ..core.perfmodel import ModelLibrary, latency_slope
from ..core.predictor import slot_groups
from ..core.routing import RoutingPolicy
from ..core.scheduler import Schedule
from ..obs import metrics as _obs_metrics
from ..obs.trace import span as _obs_span
from ..models.common import DeviceLike, resolve_device
from .chaos import FaultInjector, FaultKind, InjectedOperatorError
from .operators import SERVICE_LATENCY, Operator, make_operator
from .stream import MicroBatch, SyntheticSource, VirtualClock, WallClock


@dataclasses.dataclass
class RobustnessPolicy:
    """Retry / watchdog / shedding / breaker knobs of the live executor."""

    max_retries: int = 2                  # extra attempts per (frame, part)
    backoff_base: float = 0.004           # s; doubles per retry
    frame_deadline_intervals: float = 8.0  # watchdog: x frame interval
    shed_backlog_frames: float = 4.0      # shed when lag exceeds this many
    breaker_threshold: int = 3            # consecutive slot failures to trip


@dataclasses.dataclass
class ExecutionReport:
    omega: float
    frames: int
    tuples: int
    wall_seconds: float
    throughput: float            # tuples/s actually sustained end-to-end
    mean_latency: float
    p99_latency: float
    latency_slope: float
    stable: bool
    device_frame_counts: Dict[str, int]
    #: why ``stable`` is False ("" when stable): degenerate measurement
    #: windows report explicitly instead of crashing or silently passing
    stable_reason: str = ""
    frames_shed: int = 0         # load-shedding drops (faulted drops included)
    frames_timed_out: int = 0    # watchdog abandons
    frames_failed: int = 0       # frames that lost tuples to operator failure
    retries: int = 0             # operator attempts retried
    tuples_lost: int = 0         # tuples dropped by failed/skipped parts
    escalated_vms: Tuple[int, ...] = ()   # VMs the breaker tripped this run


@dataclasses.dataclass
class RebindInfo:
    """What :meth:`StreamExecutor.rebind` changed: the enactment delta."""

    kept_slots: List = dataclasses.field(default_factory=list)
    restarted_slots: List = dataclasses.field(default_factory=list)
    transplanted: Dict = dataclasses.field(default_factory=dict)  # old->new
    reused_ops: int = 0
    fresh_ops: int = 0


class _FrameTimeout(RuntimeError):
    """Internal: the watchdog fired mid-frame."""


def _slot_devices(device: torch.device) -> List[torch.device]:
    """The devices slots are pinned to, round-robin: every visible card
    for a bare ``cuda``, else ``device`` alone."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StreamExecutor:
    """Synchronous frame-at-a-time executor (demo-scale faithful enactment).

    ``clock`` selects wall vs virtual time; ``truth`` is the model library
    whose tables price operator work under a virtual clock (defaults to
    ``models`` — pass the *actual* measured profile to emulate a cluster
    whose reality drifted from the planner's tables); ``faults`` injects a
    :class:`~repro_torch.runtime.chaos.FaultPlan` slice; ``robustness`` tunes the
    retry/watchdog/shedding/breaker machinery; ``device`` is where the
    slots run: ``None`` or ``"cuda"`` round-robins them over every visible
    card (and raises without one), ``"cuda:i"`` pins all to card i,
    ``"cpu"`` runs the operators' plain versions on the CPU.
    """

    def __init__(self, schedule: Schedule, models: ModelLibrary,
                 *, policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
                 faults: Optional[FaultInjector] = None,
                 robustness: Optional[RobustnessPolicy] = None,
                 clock=None, truth: Optional[ModelLibrary] = None,
                 device: DeviceLike = None):
        self.schedule = schedule
        self.models = models
        self.truth = truth if truth is not None else models
        self.policy = policy
        self.faults = faults
        self.robust = robustness if robustness is not None else RobustnessPolicy()
        self.clock = clock if clock is not None else WallClock()
        self.dag = schedule.dag
        self.groups = slot_groups(schedule.mapping, schedule.allocation)
        self.device = resolve_device(device)
        self._devices = _slot_devices(self.device)
        self._device_counter = 0
        # slot -> device pinning (stable order over VMs then slots)
        self.slot_device = {}
        for slot in schedule.mapping.slots():
            self.slot_device[slot] = self._next_device()
        # operator per (task, slot), bound to the slot's device
        self._ops: Dict[Tuple[str, object], Operator] = {}
        for task, g in self.groups.items():
            kind = schedule.allocation.tasks[task].kind
            for slot in g:
                self._ops[(task, slot)] = make_operator(
                    kind, self.slot_device[slot])
        self._frame_count = defaultdict(int)
        #: operator calls that returned, by kind, across all runs
        self.invocations: Dict[str, int] = defaultdict(int)
        # robustness state (survives rebinds for surviving slots)
        self._consecutive_failures: Dict = defaultdict(int)
        self.tripped_vms: Set[int] = set()
        self._pending_escalations: List[int] = []
        # measured service accumulation: (task, slot, threads) -> [tuples,
        # busy_s] — keyed by the thread count at invocation time, so
        # samples from before and after a rebind never mix thread counts
        self._measured: Dict[Tuple[str, object, int], List[float]] = {}
        self._run_counters: Dict[str, int] = {}
        #: frames consumed across ALL runs — the fault plan's frame axis
        #: continues across measurement windows (chaos determinism)
        self.frames_seen = 0

    # -- device bookkeeping ----------------------------------------------------
    def _next_device(self):
        dev = self._devices[self._device_counter % len(self._devices)]
        self._device_counter += 1
        return dev

    # -- enactment deltas ------------------------------------------------------
    def rebind(self, new_schedule: Schedule,
               transplants: Optional[Dict] = None) -> RebindInfo:
        """Apply a controller delta in place: reuse the operator of every
        (task, slot) group the new schedule keeps, transplant the ops of
        redirected slots (``transplants``: failed slot -> replacement slot
        — the ``VmFail`` repair path, which inherits the old slot's device
        pin so the bound operator carries over verbatim), and bind fresh
        only for genuinely new groups.
        """
        old_ops = self._ops
        old_devices = dict(self.slot_device)
        transplants = dict(transplants or {})
        reverse = {new: old for old, new in transplants.items()}
        self.schedule = new_schedule
        self.dag = new_schedule.dag
        self.groups = slot_groups(new_schedule.mapping,
                                  new_schedule.allocation)
        # device pins: keep surviving slots, inherit across transplants
        # (the replacement slot takes the failed slot's device so the
        # bound operator can carry over verbatim), round-robin fresh
        live_slots = set(new_schedule.mapping.slots())
        self.slot_device = {s: d for s, d in old_devices.items()
                            if s in live_slots}
        for slot in new_schedule.mapping.slots():
            if slot in self.slot_device:
                continue
            src = reverse.get(slot)
            if src is not None and src in old_devices:
                self.slot_device[slot] = old_devices[src]
            else:
                self.slot_device[slot] = self._next_device()

        info = RebindInfo()
        self._ops = {}
        kept: Set = set()
        restarted: Set = set()
        for task, g in self.groups.items():
            kind = new_schedule.allocation.tasks[task].kind
            for slot in g:
                key = (task, slot)
                if key in old_ops:
                    self._ops[key] = old_ops[key]
                    info.reused_ops += 1
                    kept.add(slot)
                    continue
                # transplant: the redirected old slot ran the same task
                # group on the device this slot just inherited
                old_slot = reverse.get(slot)
                if (old_slot is not None and (task, old_slot) in old_ops
                        and self.slot_device[slot]
                        == old_devices.get(old_slot)):
                    self._ops[key] = old_ops[(task, old_slot)]
                    info.reused_ops += 1
                    info.transplanted[old_slot] = slot
                    restarted.add(slot)
                    continue
                self._ops[key] = make_operator(kind, self.slot_device[slot])
                info.fresh_ops += 1
                restarted.add(slot)
        info.kept_slots = sorted(kept, key=lambda s: (s.vm, s.slot))
        info.restarted_slots = sorted(restarted,
                                      key=lambda s: (s.vm, s.slot))
        # breaker state: a VM no longer in the schedule was repaired away
        live_vms = {vm.id for vm in new_schedule.vms}
        self.tripped_vms &= live_vms
        self._consecutive_failures = defaultdict(int, {
            s: n for s, n in self._consecutive_failures.items()
            if s in live_slots})
        return info

    def take_escalations(self) -> List[int]:
        """VM ids the circuit breaker tripped since the last call — the
        enactment layer turns each into a synthetic ``VmFail`` event."""
        out, self._pending_escalations = self._pending_escalations, []
        return out

    # -- measurement -----------------------------------------------------------
    def measurements(self):
        """Measured per-(task, slot-group) service samples for
        :mod:`repro_torch.core.calibrate` (kind, tau, tuples, busy seconds)."""
        from ..core.calibrate import TaskMeasurement
        out = []
        for (task, slot, q), (tuples, busy) in sorted(
                self._measured.items(),
                key=lambda kv: (kv[0][0], kv[0][1].vm, kv[0][1].slot,
                                kv[0][2])):
            if busy <= 0 or tuples <= 0:
                continue
            ta = self.schedule.allocation.tasks.get(task)
            if ta is None:
                continue
            out.append(TaskMeasurement(kind=ta.kind, task=task, tau=int(q),
                                       tuples=float(tuples),
                                       busy_seconds=float(busy)))
        return out

    def reset_measurements(self) -> None:
        self._measured = {}

    # -- routing ---------------------------------------------------------------
    def _weights(self, task: str) -> List[Tuple[object, float]]:
        g = self.groups[task]
        kind = self.schedule.allocation.tasks[task].kind
        model = self.models[kind]
        if self.policy is RoutingPolicy.SLOT_AWARE:
            w = {s: max(model.I(q), 1e-9) for s, q in g.items()}
        else:
            w = {s: float(q) for s, q in g.items()}
        total = sum(w.values())
        return [(s, w[s] / total) for s in sorted(w, key=lambda s: (s.vm, s.slot))]

    # -- execution ---------------------------------------------------------------
    def _virtual_cost(self, task: str, slot, n: int) -> float:
        """Model-implied processing time of ``n`` tuples on this slot group
        under the ``truth`` tables (the virtual clock's cost source)."""
        kind = self.schedule.allocation.tasks[task].kind
        q = self.groups[task][slot]
        cap = float(self.truth[kind].I(q))
        return n / max(cap, 1e-9)

    def _invoke_part(self, task: str, slot, part, frame_seq: int,
                     deadline_at: float) -> Optional[Dict[str, torch.Tensor]]:
        """One routed part through retry/backoff, fault injection, and the
        circuit breaker.  Returns the operator output, or None when the
        part was lost (exhausted retries / tripped VM)."""
        n = next(iter(part.values())).shape[0]
        fail_attempts = 0
        slow = 1.0
        if self.faults is not None:
            fail_attempts = self.faults.error_attempts(frame_seq, task, slot)
            slow = self.faults.slowdown(frame_seq, task, slot)
            stall = self.faults.stall(frame_seq, task, slot)
            if stall > 0:
                # a stalled attempt blocks until the watchdog budget runs out
                self.clock.sleep(min(stall,
                                     max(0.0, deadline_at - self.clock.now())
                                     + 1e-9))
        op = self._ops[(task, slot)]
        for attempt in range(self.robust.max_retries + 1):
            if self.clock.now() > deadline_at:
                raise _FrameTimeout(f"frame {frame_seq} exceeded its "
                                    f"deadline at task {task!r}")
            try:
                if attempt < fail_attempts:
                    raise InjectedOperatorError(
                        FaultKind.OPERATOR_ERROR
                        if not self.faults.is_crashed(slot.vm)
                        else FaultKind.VM_CRASH, task)
                t0 = time.perf_counter()
                out = op(part)
                if self.clock.virtual:
                    busy = self._virtual_cost(task, slot, n)
                else:
                    _synchronize(op.device)    # the work, not the launch
                    busy = time.perf_counter() - t0
                self.invocations[op.kind] += 1
                busy *= slow
                if slow > 1.0 and not self.clock.virtual:
                    # realize the slowdown in wall time too
                    self.clock.sleep(busy - busy / slow)
                self._consecutive_failures[slot] = 0
                q = self.groups[task][slot]
                acc = self._measured.setdefault((task, slot, int(q)),
                                                [0.0, 0.0])
                acc[0] += n
                acc[1] += busy
                return out
            except _FrameTimeout:
                raise
            except Exception:
                if attempt >= self.robust.max_retries:
                    break
                self._run_counters["retries"] = \
                    self._run_counters.get("retries", 0) + 1
                self.clock.sleep(self.robust.backoff_base * (2 ** attempt))
        # retries exhausted: part lost; feed the breaker
        self._run_counters["tuples_lost"] = \
            self._run_counters.get("tuples_lost", 0) + n
        self._consecutive_failures[slot] += 1
        if (self._consecutive_failures[slot] >= self.robust.breaker_threshold
                and slot.vm not in self.tripped_vms):
            self.tripped_vms.add(slot.vm)
            self._pending_escalations.append(slot.vm)
        return None

    def _run_task(self, task: str, arrays: Dict[str, torch.Tensor],
                  frame_seq: int = -1,
                  deadline_at: float = float("inf")
                  ) -> Dict[str, torch.Tensor]:
        g = self.groups.get(task)
        if not g:
            return arrays
        kind = self.schedule.allocation.tasks[task].kind
        n = next(iter(arrays.values())).shape[0]
        weights = self._weights(task)
        # split the frame over slot groups
        cuts, acc = [], 0.0
        for _, f in weights[:-1]:
            acc += f
            cuts.append(int(round(acc * n)))
        parts = {}
        lo = 0
        lost = False
        for (slot, _), hi in zip(weights, cuts + [n]):
            if hi > lo:
                if slot.vm in self.tripped_vms:
                    # breaker open: skip the dead VM's share entirely
                    self._run_counters["tuples_lost"] = \
                        self._run_counters.get("tuples_lost", 0) + (hi - lo)
                    lost = True
                    lo = hi
                    continue
                part = {k: v[lo:hi] for k, v in arrays.items()}
                out = self._invoke_part(task, slot, part, frame_seq,
                                        deadline_at)
                if out is None:
                    lost = True
                else:
                    parts[slot] = out
                    self._frame_count[str(self.slot_device[slot])] += 1
            lo = hi
        if lost:
            self._run_counters["frame_lost_tuples"] = 1
        if kind in SERVICE_LATENCY:
            # external service wait, parallelized over the task's threads
            q_total = sum(g.values())
            self.clock.sleep(SERVICE_LATENCY[kind] / max(1, q_total))
        outs = list(parts.values())
        if not outs:
            return arrays if not lost else {}
        if len(outs) == 1:
            return outs[0]
        # interleave across slots: gather to one device (the real tuple
        # movement between slots that Storm's network transfer performs)
        home = self.slot_device[next(iter(parts))]
        keys = outs[0].keys()
        return {k: torch.cat([o[k].to(home) for o in outs], dim=0)
                for k in keys}

    def process_frame(self, frame: MicroBatch, interval: float
                      ) -> Tuple[str, Optional[float]]:
        """Run one frame through the dataflow with the full robustness
        stack.  Returns ``(status, latency)`` with status one of ``"ok"``,
        ``"shed"``, ``"timeout"``, ``"failed"``; latency is set for ok
        frames only."""
        now = self.clock.now()
        if interval > 0 and (now - frame.created) > \
                self.robust.shed_backlog_frames * interval:
            self._run_counters["frames_shed"] = \
                self._run_counters.get("frames_shed", 0) + 1
            return "shed", None
        if self.faults is not None:
            self.faults.crashed_vms(frame.seq,
                                    [vm.id for vm in self.schedule.vms])
            if self.faults.drop_frame(frame.seq):
                self._run_counters["frames_shed"] = \
                    self._run_counters.get("frames_shed", 0) + 1
                return "shed", None
        deadline_at = (now + self.robust.frame_deadline_intervals * interval
                       if interval > 0 else float("inf"))
        self._run_counters.pop("frame_lost_tuples", None)
        topo = self.dag.topo_order()
        outputs: Dict[str, Dict[str, torch.Tensor]] = {}
        try:
            for t in topo:
                ins = self.dag.in_edges(t.name)
                if not ins:
                    arrays = frame.arrays
                else:
                    upstream = [outputs[e.src] for e in ins
                                if e.src in outputs and outputs[e.src]]
                    if not upstream:
                        continue
                    arrays = upstream[0]  # interleave: take one copy (sel 1:1)
                outputs[t.name] = self._run_task(t.name, arrays, frame.seq,
                                                 deadline_at)
        except _FrameTimeout:
            self._run_counters["frames_timed_out"] = \
                self._run_counters.get("frames_timed_out", 0) + 1
            return "timeout", None
        # block on one sink output to get a truthful completion time
        for snk in self.dag.sinks():
            out = outputs.get(snk.name)
            if out:
                _synchronize(next(iter(out.values())).device)
        if self._run_counters.pop("frame_lost_tuples", None):
            self._run_counters["frames_failed"] = \
                self._run_counters.get("frames_failed", 0) + 1
            return "failed", None
        return "ok", self.clock.now() - frame.created

    def run(self, omega: float, *, duration: float = 2.0,
            batch: int = 32, warmup_frames: int = 2,
            n_frames: Optional[int] = None, seed: int = 0) -> ExecutionReport:
        with _obs_span("executor.run", dag=self.schedule.dag.name,
                       omega=float(omega)):
            report = self._run(omega, duration=duration, batch=batch,
                               warmup_frames=warmup_frames,
                               n_frames=n_frames, seed=seed)
        if _obs_metrics.REGISTRY.enabled:
            _obs_metrics.observe_execution_report(report)
        return report

    def _run(self, omega: float, *, duration: float = 2.0,
             batch: int = 32, warmup_frames: int = 2,
             n_frames: Optional[int] = None, seed: int = 0) -> ExecutionReport:
        source = SyntheticSource(omega, batch=batch, seed=seed,
                                 clock=self.clock,
                                 start_seq=self.frames_seen,
                                 device=self._devices[0])
        interval = batch / omega if omega > 0 else 0.0
        latencies: List[float] = []
        tuples = 0
        counters = self._run_counters = {}
        escalated_before = list(self._pending_escalations)
        t0 = self.clock.now()
        frames = 0
        for frame in source.frames(duration, n_frames=n_frames):
            status, latency = self.process_frame(frame, interval)
            frames += 1
            if status == "ok":
                tuples += frame.size
                if frames > warmup_frames:
                    latencies.append(latency)
        self.frames_seen += frames
        wall = self.clock.now() - t0
        slope = latency_slope(latencies)
        mean_lat = float(np.mean(latencies)) if latencies else 0.0
        p99 = float(np.percentile(latencies, 99)) if latencies else 0.0
        # Stability: a genuinely overloaded executor falls behind its source
        # by ~(service - interval) per frame, i.e. the latency slope is on
        # the order of the frame interval.  Wall-clock jitter on the few
        # measured frames is far smaller, so judge the slope against a
        # fraction of the interval rather than an absolute constant.
        stable = slope <= max(1e-3, 0.05 * interval)
        reason = "" if stable else (
            f"latency slope {slope:.4g} s/frame exceeds the stability "
            f"bound for interval {interval:.4g} s")
        if not latencies:
            # degenerate window: zero post-warmup samples means nothing was
            # measured — report explicitly instead of vacuously passing
            stable = False
            reason = (f"no post-warmup latency samples (frames={frames}, "
                      f"warmup={warmup_frames}, "
                      f"shed={counters.get('frames_shed', 0)}, "
                      f"timed_out={counters.get('frames_timed_out', 0)}, "
                      f"failed={counters.get('frames_failed', 0)})")
        new_escalations = [v for v in self._pending_escalations
                           if v not in escalated_before]
        return ExecutionReport(
            omega=omega, frames=frames, tuples=tuples, wall_seconds=wall,
            throughput=tuples / wall if wall > 0 else 0.0,
            mean_latency=mean_lat, p99_latency=p99, latency_slope=slope,
            stable=stable, stable_reason=reason,
            device_frame_counts=dict(self._frame_count),
            frames_shed=counters.get("frames_shed", 0),
            frames_timed_out=counters.get("frames_timed_out", 0),
            frames_failed=counters.get("frames_failed", 0),
            retries=counters.get("retries", 0),
            tuples_lost=counters.get("tuples_lost", 0),
            escalated_vms=tuple(new_escalations),
        )
