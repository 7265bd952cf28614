"""Deterministic, seed-replayable fault injection for the live runtime.

The robustness claim of the reproduction — the planner's model-driven
schedules survive the failures a real cluster throws at them — is only
falsifiable if the failures themselves are *reproducible*.  This module
provides that: a :class:`FaultPlan` is a pure-data description of every
fault a replay will see, keyed exclusively on deterministic coordinates
(DAG name, frame sequence number, task name, VM index), never on wall
clock.  Two replays of the same plan therefore produce bit-identical
fault timelines (``tests/test_chaos.py`` pins this).

Fault taxonomy (the RIoTBench / event-storm failure modes):

``OPERATOR_ERROR``   the operator body raises for ``count`` consecutive
                     attempts at a (frame, task) coordinate — transient
                     for small counts (the retry path absorbs it),
                     persistent for large ones (the circuit breaker
                     escalates).
``SLOT_SLOWDOWN``    every part processed by the targeted task/VM runs
                     ``factor``× slower for ``frames`` frames (CPU
                     contention, noisy neighbours).
``SLOT_STALL``       one processing attempt blocks for ``seconds`` —
                     long enough to trip the frame-timeout watchdog.
``DROP_FRAME``       the frame is lost between routing and the operator
                     (network drop); counted as shed load.
``VM_CRASH``         every operator on the VM fails persistently from
                     ``frame`` onward — repair requires the controller
                     to replace the VM (``VmFail``).  Correlated storms
                     are several VM_CRASH faults sharing one frame.

The :class:`FaultInjector` is the per-executor active view: the executor
consults it between routing and ``_run_task`` and every injected fault is
appended to the injector's :class:`FaultTimeline`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


class FaultKind(enum.Enum):
    OPERATOR_ERROR = "operator_error"
    SLOT_SLOWDOWN = "slot_slowdown"
    SLOT_STALL = "slot_stall"
    DROP_FRAME = "drop_frame"
    VM_CRASH = "vm_crash"

    def __str__(self) -> str:  # pragma: no cover - repr aid
        return self.value


class InjectedOperatorError(RuntimeError):
    """The exception an OPERATOR_ERROR / VM_CRASH fault raises in place of
    the operator body."""

    def __init__(self, kind: FaultKind, task: str, detail: str = ""):
        super().__init__(f"injected {kind.value} at task {task!r}"
                         + (f": {detail}" if detail else ""))
        self.fault_kind = kind
        self.task = task


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault, addressed by deterministic coordinates.

    ``dag=None`` matches every DAG; ``task=None`` matches every task;
    VM targeting is by ``vm_index`` — the position in the schedule's VM
    list at injection time — because absolute VM ids are minted by the
    controller and unknown when a plan is authored.
    """

    kind: FaultKind
    frame: int                       # first frame seq the fault applies to
    dag: Optional[str] = None
    task: Optional[str] = None
    vm_index: Optional[int] = None
    frames: int = 1                  # duration in frames (slowdown / drop)
    count: int = 1                   # consecutive failing attempts (errors)
    factor: float = 2.0              # slowdown multiplier
    seconds: float = 0.0             # stall duration

    def matches_dag(self, dag: str) -> bool:
        return self.dag is None or self.dag == dag

    def active(self, frame: int) -> bool:
        return self.frame <= frame < self.frame + self.frames


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One realized injection — the unit of the replayable timeline."""

    frame: int
    dag: str
    kind: FaultKind
    task: str        # "" for frame/VM-scoped faults
    target: str      # slot / vm / frame coordinate, stringified
    detail: str


@dataclasses.dataclass
class FaultTimeline:
    """Ordered record of every injected fault of one replay."""

    events: List[FaultEvent] = dataclasses.field(default_factory=list)

    def add(self, ev: FaultEvent) -> None:
        self.events.append(ev)

    def signature(self) -> Tuple[Tuple, ...]:
        """Hashable bit-exact identity of the timeline (determinism pin)."""
        return tuple(
            (e.frame, e.dag, e.kind.value, e.task, e.target, e.detail)
            for e in self.events)

    def __len__(self) -> int:
        return len(self.events)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A pure-data, time-free fault schedule for a whole fleet replay."""

    faults: Tuple[Fault, ...] = ()
    seed: Optional[int] = None

    @classmethod
    def none(cls) -> "FaultPlan":
        """The empty plan — the fault-free no-op rail."""
        return cls(faults=(), seed=None)

    @classmethod
    def from_seed(cls, seed: int, *, dags: Sequence[str], tasks: Sequence[str],
                  horizon_frames: int = 24, operator_errors: int = 2,
                  slowdowns: int = 2, stalls: int = 0, drops: int = 1,
                  vm_crashes: int = 0, correlated_crash: bool = False,
                  crash_frame: Optional[int] = None) -> "FaultPlan":
        """Generate a bursty fault mix deterministically from ``seed``.

        Every coordinate is drawn from one ``np.random.default_rng(seed)``
        stream in a fixed order, so the same arguments always produce the
        same plan — and two replays of that plan produce bit-identical
        timelines.  ``correlated_crash`` adds an event-storm-style
        correlated failure (two VM_CRASH faults sharing one frame).
        """
        rng = np.random.default_rng(seed)
        dags = list(dags)
        tasks = list(tasks)
        faults: List[Fault] = []
        for _ in range(operator_errors):
            faults.append(Fault(
                FaultKind.OPERATOR_ERROR,
                frame=int(rng.integers(1, horizon_frames)),
                dag=dags[int(rng.integers(len(dags)))],
                task=tasks[int(rng.integers(len(tasks)))],
                count=int(rng.integers(1, 3))))
        for _ in range(slowdowns):
            faults.append(Fault(
                FaultKind.SLOT_SLOWDOWN,
                frame=int(rng.integers(1, horizon_frames)),
                dag=dags[int(rng.integers(len(dags)))],
                task=tasks[int(rng.integers(len(tasks)))],
                frames=int(rng.integers(2, 5)),
                factor=float(np.round(1.5 + 2.5 * rng.random(), 3))))
        for _ in range(stalls):
            faults.append(Fault(
                FaultKind.SLOT_STALL,
                frame=int(rng.integers(1, horizon_frames)),
                dag=dags[int(rng.integers(len(dags)))],
                task=tasks[int(rng.integers(len(tasks)))],
                seconds=float(np.round(0.5 + rng.random(), 3))))
        for _ in range(drops):
            faults.append(Fault(
                FaultKind.DROP_FRAME,
                frame=int(rng.integers(1, horizon_frames)),
                dag=dags[int(rng.integers(len(dags)))]))
        for _ in range(vm_crashes):
            faults.append(Fault(
                FaultKind.VM_CRASH,
                frame=int(rng.integers(1, horizon_frames)),
                dag=dags[int(rng.integers(len(dags)))],
                vm_index=int(rng.integers(0, 2))))
        if correlated_crash:
            cf = (int(rng.integers(2, max(3, horizon_frames // 2)))
                  if crash_frame is None else int(crash_frame))
            victim = dags[int(rng.integers(len(dags)))]
            faults.append(Fault(FaultKind.VM_CRASH, frame=cf, dag=victim,
                                vm_index=0))
            faults.append(Fault(FaultKind.VM_CRASH, frame=cf, dag=victim,
                                vm_index=1))
        faults.sort(key=lambda f: (f.frame, f.kind.value, f.dag or "",
                                   f.task or "", f.vm_index or -1))
        return cls(faults=tuple(faults), seed=seed)

    def for_dag(self, dag: str) -> Tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.matches_dag(dag))

    def __len__(self) -> int:
        return len(self.faults)


class FaultInjector:
    """Per-executor active view of one DAG's slice of a :class:`FaultPlan`.

    The executor consults it between routing and ``_run_task``:

    * :meth:`drop_frame` — frame-scoped drops;
    * :meth:`error_attempts` — how many consecutive attempts at
      (frame, task, slot) must fail (decremented per retry by the caller
      via the returned budget);
    * :meth:`slowdown` / :meth:`stall` — extra processing cost;
    * :meth:`crashed` — VM-scoped persistent failure (until the VM id is
      replaced by repair; replacements carry fresh ids, so they are
      healthy by construction).

    Every consultation that fires appends to :attr:`timeline`.
    """

    def __init__(self, plan: FaultPlan, dag: str,
                 timeline: Optional[FaultTimeline] = None):
        self.plan = plan
        self.dag = dag
        self.faults = plan.for_dag(dag)
        self.timeline = timeline if timeline is not None else FaultTimeline()
        #: VM ids realized as crashed (resolved from vm_index at first
        #: injection against the executor's VM list)
        self._crashed_ids: Set[int] = set()
        self._crash_logged: Set[Tuple[int, int]] = set()
        #: VM_CRASH faults (by index into ``self.faults``) already realized
        #: — a crash fires once, against the VM list of the frame it hits;
        #: repair replacements carry fresh ids and stay healthy
        self._fired_crashes: Set[int] = set()

    # -- frame-scoped --------------------------------------------------------
    def drop_frame(self, frame: int) -> bool:
        for f in self.faults:
            if f.kind is FaultKind.DROP_FRAME and f.active(frame):
                self._log(frame, f.kind, "", f"frame#{frame}",
                          "frame dropped between routing and operators")
                return True
        return False

    # -- VM-scoped -----------------------------------------------------------
    def crashed_vms(self, frame: int, vm_ids: Sequence[int]) -> Set[int]:
        """Resolve VM_CRASH faults active at ``frame`` against the
        executor's current VM id list; crashed ids persist until repair
        replaces them (fresh ids never match)."""
        vm_ids = list(vm_ids)
        for i, f in enumerate(self.faults):
            if (f.kind is not FaultKind.VM_CRASH or frame < f.frame
                    or i in self._fired_crashes):
                continue
            self._fired_crashes.add(i)
            if f.vm_index is None or f.vm_index >= len(vm_ids):
                continue
            vid = vm_ids[f.vm_index]
            if vid in self._crashed_ids:
                continue
            self._crashed_ids.add(vid)
            self._log(frame, f.kind, "", f"vm{vid}",
                      f"VM crash (vm_index={f.vm_index})")
        return {v for v in self._crashed_ids if v in vm_ids}

    def is_crashed(self, vm_id: int) -> bool:
        return vm_id in self._crashed_ids

    # -- task/slot-scoped ----------------------------------------------------
    def error_attempts(self, frame: int, task: str, slot) -> int:
        """Consecutive attempts that must fail at this coordinate (0 =
        healthy).  VM crashes dominate: every attempt on a crashed VM
        fails."""
        if slot.vm in self._crashed_ids:
            key = (frame, slot.vm)
            if key not in self._crash_logged:
                self._crash_logged.add(key)
                self._log(frame, FaultKind.VM_CRASH, task, repr(slot),
                          f"attempt on crashed vm{slot.vm}")
            return 1 << 30
        n = 0
        for f in self.faults:
            if (f.kind is FaultKind.OPERATOR_ERROR and f.active(frame)
                    and (f.task is None or f.task == task)):
                n = max(n, f.count)
        if n:
            self._log(frame, FaultKind.OPERATOR_ERROR, task, repr(slot),
                      f"{n} failing attempt(s)")
        return n

    def slowdown(self, frame: int, task: str, slot) -> float:
        factor = 1.0
        for f in self.faults:
            if (f.kind is FaultKind.SLOT_SLOWDOWN and f.active(frame)
                    and (f.task is None or f.task == task)):
                factor *= f.factor
        if factor != 1.0:
            self._log(frame, FaultKind.SLOT_SLOWDOWN, task, repr(slot),
                      f"factor={factor:g}")
        return factor

    def stall(self, frame: int, task: str, slot) -> float:
        secs = 0.0
        for f in self.faults:
            if (f.kind is FaultKind.SLOT_STALL and f.active(frame)
                    and (f.task is None or f.task == task)):
                secs += f.seconds
        if secs:
            self._log(frame, FaultKind.SLOT_STALL, task, repr(slot),
                      f"stall={secs:g}s")
        return secs

    # -- internals -----------------------------------------------------------
    def _log(self, frame: int, kind: FaultKind, task: str, target: str,
             detail: str) -> None:
        self.timeline.add(FaultEvent(frame=frame, dag=self.dag, kind=kind,
                                     task=task, target=target, detail=detail))


#: A null injector usable where "no faults" must still satisfy the
#: injector interface.
def null_injector(dag: str = "") -> FaultInjector:
    return FaultInjector(FaultPlan.none(), dag)
