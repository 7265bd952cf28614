"""Resource mapping (paper §7): acquisition (§7.1), DSM, RSM, SAM.

Thread-to-slot mapping operates on:

* :class:`VM` — a host with ``p_j`` homogeneous slots (one core + memory
  quantum each).  On the TPU adaptation a "VM" is an ICI-connected host and a
  "slot" is one chip.
* :class:`Thread` — one data-parallel executor ``r_i^k`` of task ``t_i``.
* :class:`Mapping` — the function ``M : R -> S`` plus residual-capacity
  bookkeeping, so predictors/simulators can inspect per-slot co-location.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import (Dict, Iterable, List, Mapping as TMapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np

from .allocation import Allocation, TaskAllocation
from .dag import Dataflow
from .perfmodel import ModelLibrary


class InsufficientResourcesError(RuntimeError):
    """Raised when a resource-aware mapper cannot place a thread (RSM line 16,
    SAM lines 10/19).  The scheduler reacts by acquiring one more slot and
    retrying (§8.4)."""

    def __init__(self, task: str, message: str = ""):
        super().__init__(message or f"insufficient resources for task {task!r}")
        self.task = task


@dataclasses.dataclass(frozen=True)
class Thread:
    task: str
    index: int

    def __repr__(self) -> str:
        return f"{self.task}#{self.index}"


@dataclasses.dataclass(frozen=True)
class SlotId:
    vm: int
    slot: int

    def __repr__(self) -> str:
        return f"s{self.vm}.{self.slot}"


#: Azure D-series pricing per slot-hour (paper §7.1: price is proportional
#: to slots — $0.098/slot/h across D1..D4).
PRICE_PER_SLOT_HOUR = 0.098


@dataclasses.dataclass(frozen=True)
class VmClass:
    """A typed VM offering (§7.1 generalized): ``slots`` homogeneous slots
    whose threads each serve ``speed``× the profiled §6 service rate, priced
    at ``cost_per_hour`` dollars (default: the paper's slot-proportional
    D-series price) with ``mem_per_slot`` memory quanta per slot."""

    name: str
    slots: int
    speed: float = 1.0
    cost_per_hour: Optional[float] = None
    mem_per_slot: float = 1.0

    def __post_init__(self) -> None:
        if self.slots <= 0:
            raise ValueError(f"VmClass {self.name!r}: slots must be positive")
        if not (math.isfinite(self.speed) and self.speed > 0):
            raise ValueError(f"VmClass {self.name!r}: speed must be positive "
                             "and finite")
        if self.cost_per_hour is None:
            object.__setattr__(self, "cost_per_hour",
                               self.slots * PRICE_PER_SLOT_HOUR)
        if not (math.isfinite(self.cost_per_hour)
                and self.cost_per_hour >= 0):
            raise ValueError(f"VmClass {self.name!r}: cost_per_hour must be "
                             ">= 0 and finite")
        if not (math.isfinite(self.mem_per_slot) and self.mem_per_slot > 0):
            raise ValueError(f"VmClass {self.name!r}: mem_per_slot must be "
                             "positive and finite")


def vm_classes_from_sizes(sizes: Sequence[int], *, speed: float = 1.0,
                          price_per_slot_hour: float = PRICE_PER_SLOT_HOUR,
                          mem_per_slot: float = 1.0,
                          prefix: str = "d") -> Tuple[VmClass, ...]:
    """Unit-speed, slot-proportionally-priced classes for integer sizes —
    the homogeneous baseline every heterogeneous path must reproduce
    bit-identically."""
    return tuple(
        VmClass(f"{prefix}{s}", int(s), speed=speed,
                cost_per_hour=int(s) * price_per_slot_hour,
                mem_per_slot=mem_per_slot)
        for s in sorted({int(s) for s in sizes}, reverse=True))


#: Named class families used by the repo's planners: the paper's Azure
#: D-series (D3=4/D2=2/D1=1 slots), the serving planner's TPU hosts, and
#: the data-pipeline hosts (8-core machines down to singles).
VM_CLASS_FAMILIES: Dict[str, Tuple[VmClass, ...]] = {
    "azure-d": vm_classes_from_sizes((4, 2, 1)),
    "tpu-host": vm_classes_from_sizes((4, 2, 1), prefix="host"),
    "pipeline-host": vm_classes_from_sizes((8, 4, 2, 1), prefix="host"),
}


def vm_class_family(name: str) -> Tuple[VmClass, ...]:
    """A registered class family by name (``ValueError`` on unknown)."""
    try:
        return VM_CLASS_FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown VM class family {name!r}; registered: "
            f"{sorted(VM_CLASS_FAMILIES)}") from None


#: A ``vm_sizes`` argument anywhere in the planning stack: plain int slot
#: counts (the §7.1 baseline), :class:`VmClass` objects, or a registered
#: family name.
VmSizesArg = Union[str, Sequence[int], Sequence[VmClass]]


def resolve_vm_classes(vm_sizes: VmSizesArg) -> Tuple[VmClass, ...]:
    """Normalize a ``vm_sizes`` argument into :class:`VmClass` objects.
    Plain ints become anonymous unit-speed classes at the default price."""
    if isinstance(vm_sizes, str):
        return vm_class_family(vm_sizes)
    out: List[VmClass] = []
    seen = set()
    for s in vm_sizes:
        c = s if isinstance(s, VmClass) else VmClass(f"d{int(s)}", int(s))
        if c.name in seen:
            continue
        seen.add(c.name)
        out.append(c)
    if not out:
        raise ValueError("vm_sizes must name at least one class/size")
    return tuple(out)


def vm_sizes_speed(vm_sizes: VmSizesArg) -> float:
    """Common slot speed of a ``vm_sizes`` spec (1.0 for plain int sizes).
    Mixed speeds raise: one acquisition pools one speed — mixed-speed
    fleets plan per class (the ``min_cost`` objective)."""
    if not isinstance(vm_sizes, str) \
            and not any(isinstance(s, VmClass) for s in vm_sizes):
        return 1.0
    speeds = {c.speed for c in resolve_vm_classes(vm_sizes)}
    if len(speeds) > 1:
        raise ValueError(f"mixed slot speeds {sorted(speeds)} in one pool; "
                         "plan per class instead")
    return speeds.pop()


@dataclasses.dataclass
class VM:
    id: int
    num_slots: int
    rack: int = 0
    #: heterogeneity metadata — defaults reproduce the homogeneous unit-slot
    #: model, so ``VM(id, slots, rack)`` construction and equality are
    #: unchanged for every pre-existing call site
    speed: float = 1.0
    vm_class: str = ""
    cost_per_hour: Optional[float] = None
    mem_per_slot: float = 1.0

    @property
    def price_per_hour(self) -> float:
        if self.cost_per_hour is not None:
            return self.cost_per_hour
        return self.num_slots * PRICE_PER_SLOT_HOUR

    def slot_ids(self) -> List[SlotId]:
        return [SlotId(self.id, l) for l in range(self.num_slots)]


def pool_cost_per_hour(vms: Sequence[VM]) -> float:
    """Total $/hour of a VM pool (§7.1 pricing; class costs when tagged)."""
    return float(sum(vm.price_per_hour for vm in vms))


def pool_speed(vms: Sequence[VM], *, default: float = 1.0) -> float:
    """The pool's common slot speed (``default`` for an empty pool); a
    mixed-speed pool raises — allocation semantics are per-speed."""
    speeds = {vm.speed for vm in vms}
    if not speeds:
        return default
    if len(speeds) > 1:
        raise ValueError(f"mixed-speed VM pool {sorted(speeds)}")
    return speeds.pop()


def unit_vm_like(vm_id: int, pool: Sequence[VM]) -> VM:
    """A fresh 1-slot VM matching the pool's speed/memory shape — the §8.4
    +1-slot retry on a heterogeneous pool must not change its class
    semantics.  An empty pool gets the plain unit VM."""
    if not pool:
        return VM(vm_id, 1)
    ref = pool[0]
    return VM(vm_id, 1, speed=ref.speed, mem_per_slot=ref.mem_per_slot)


def nw_dist(ref: Optional[VM], cand: VM) -> float:
    """R-Storm network latency multiplier: 0 same VM, 0.5 same rack, 1.0
    otherwise (§7.3)."""
    if ref is None or ref.id == cand.id:
        return 0.0
    if ref.rack == cand.rack:
        return 0.5
    return 1.0


# ---------------------------------------------------------------------------
# §7.1 Resource acquisition.
# ---------------------------------------------------------------------------

#: Azure D-series-like sizes used throughout the paper: D3=4, D2=2, D1=1 slots.
DEFAULT_VM_SIZES: Tuple[int, ...] = (4, 2, 1)


def _greedy_counts(rho: int, sizes: Sequence[int]) -> List[int]:
    """§7.1 greedy slot counts: as many largest-size VMs as fit, then the
    smallest size that covers the remainder."""
    sizes = sorted(set(sizes), reverse=True)
    largest = sizes[0]
    n_large, rem = divmod(rho, largest)
    counts = [largest] * n_large
    if rem:
        fitting = [s for s in sorted(sizes) if s >= rem]
        counts.append(fitting[0] if fitting else largest)
    return counts


def _proportional_price(classes: Sequence[VmClass]) -> Optional[float]:
    """The common per-slot $/hour when every class is priced proportionally
    to its slots, else ``None`` (→ genuinely heterogeneous costs)."""
    per_slot = classes[0].cost_per_hour / classes[0].slots
    for c in classes:
        if not math.isclose(c.cost_per_hour, per_slot * c.slots,
                            rel_tol=1e-9, abs_tol=1e-12):
            return None
    return per_slot


def _acquire_min_cost(rho: int, classes: Sequence[VmClass]) -> List[VmClass]:
    """Exact min-cost covering multiset over heterogeneous-cost classes:
    pseudo-polynomial DP over remaining slots.  Ties prefer fewer VMs, then
    fewer total slots; reconstruction is deterministic (larger classes
    first)."""
    order = sorted(classes, key=lambda c: (-c.slots, c.name))

    def better(a: Tuple[float, int, int], b: Tuple[float, int, int]) -> bool:
        # float cost sums of equal-value paths can differ by ulps depending
        # on addition order; compare with a tolerance so the (n_vms,
        # total_slots) tie-breaks decide true ties instead of the ulps
        if a[0] < b[0] - 1e-9:
            return True
        if a[0] > b[0] + 1e-9:
            return False
        return (a[1], a[2]) < (b[1], b[2])

    # best[r] = (cost, n_vms, total_slots) to cover r remaining slots
    best: List[Optional[Tuple[float, int, int]]] = [(0.0, 0, 0)]
    choice: List[int] = [-1]
    for r in range(1, rho + 1):
        cell: Optional[Tuple[float, int, int]] = None
        pick = -1
        for ci, c in enumerate(order):
            prev = best[max(0, r - c.slots)]
            cand = (prev[0] + c.cost_per_hour, prev[1] + 1, prev[2] + c.slots)
            if cell is None or better(cand, cell):
                cell, pick = cand, ci
        best.append(cell)
        choice.append(pick)
    chosen: List[VmClass] = []
    r = rho
    while r > 0:
        c = order[choice[r]]
        chosen.append(c)
        r = max(0, r - c.slots)
    chosen.sort(key=lambda c: (-c.slots, c.name))
    return chosen


def acquire_vms(rho: int, vm_sizes: VmSizesArg = DEFAULT_VM_SIZES,
                *, rack_size: int = 32) -> List[VM]:
    """Acquire VMs covering ``rho`` slots (§7.1, generalized to typed
    classes).  Plain int sizes — and class families whose prices are
    slot-proportional — use the paper's greedy (largest size first, then
    the smallest size covering the remainder) and reproduce the unit-slot
    pools bit-identically.  Genuinely heterogeneous costs switch to an
    exact min-cost covering DP.  ``rack_size`` VMs share a rack."""
    if rho <= 0:
        raise ValueError("rho must be positive")
    if not isinstance(vm_sizes, str) \
            and not any(isinstance(s, VmClass) for s in vm_sizes):
        # Legacy §7.1 path: anonymous unit classes, bit-identical pools.
        counts = _greedy_counts(rho, [int(s) for s in vm_sizes])
        return [VM(i, s, rack=i // rack_size) for i, s in enumerate(counts)]
    classes = resolve_vm_classes(vm_sizes)
    if len({c.speed for c in classes}) > 1:
        raise ValueError("acquire_vms pools one speed per acquisition; "
                         "mixed-speed fleets plan per class (min_cost)")
    if _proportional_price(classes) is not None:
        # Uniform $/slot: cost-minimal = slot-minimal, so the §7.1 greedy
        # is cost-optimal and keeps pool shapes identical to the baseline.
        by_slots: Dict[int, VmClass] = {}
        for c in classes:
            by_slots.setdefault(c.slots, c)
        counts = _greedy_counts(rho, list(by_slots))
        chosen = [by_slots[s] for s in counts]
    else:
        chosen = _acquire_min_cost(rho, classes)
    return [VM(i, c.slots, rack=i // rack_size, speed=c.speed,
               vm_class=c.name, cost_per_hour=c.cost_per_hour,
               mem_per_slot=c.mem_per_slot)
            for i, c in enumerate(chosen)]


# ---------------------------------------------------------------------------
# Mapping result with capacity bookkeeping.
# ---------------------------------------------------------------------------

class Mapping:
    """Thread -> slot assignment plus residual-capacity accounting."""

    def __init__(self, vms: Sequence[VM]):
        self.vms: List[VM] = list(vms)
        self.assignment: Dict[Thread, SlotId] = {}
        # Residual capacity views (fractions of a slot).
        self.slot_cpu: Dict[SlotId, float] = {}
        self.slot_mem: Dict[SlotId, float] = {}
        for vm in self.vms:
            for s in vm.slot_ids():
                self.slot_cpu[s] = 1.0
                self.slot_mem[s] = vm.mem_per_slot
        # slot → threads index kept in sync by ``assign``: slot lookups are
        # O(|slot|) instead of O(R) scans over the whole assignment (SAM's
        # ``next_full_slot`` probes every slot, which used to be O(R·S)).
        # Entries are created lazily at a slot's first assignment so dict
        # iteration order matches the old assignment-order scans.
        self._slot_threads: Dict[SlotId, List[Thread]] = {}
        self._slot_counts: Dict[SlotId, Dict[str, int]] = {}

    # -- assignment ----------------------------------------------------------
    def assign(self, thread: Thread, slot: SlotId,
               cpu: float = 0.0, mem: float = 0.0) -> None:
        if thread in self.assignment:
            raise ValueError(f"{thread} already mapped")
        self.assignment[thread] = slot
        self.slot_cpu[slot] -= cpu
        self.slot_mem[slot] -= mem
        self._slot_threads.setdefault(slot, []).append(thread)
        counts = self._slot_counts.setdefault(slot, {})
        counts[thread.task] = counts.get(thread.task, 0) + 1

    # -- views ----------------------------------------------------------------
    def slots(self) -> List[SlotId]:
        return [s for vm in self.vms for s in vm.slot_ids()]

    def used_slots(self) -> List[SlotId]:
        used = {s for s, ts in self._slot_threads.items() if ts}
        return [s for s in self.slots() if s in used]

    def threads_on_slot(self, slot: SlotId) -> List[Thread]:
        return list(self._slot_threads.get(slot, ()))

    def slot_task_counts(self) -> Dict[SlotId, Dict[str, int]]:
        """Per-slot thread counts grouped by task — the co-location structure
        consumed by the predictor/simulator."""
        return {s: dict(c) for s, c in self._slot_counts.items() if c}

    def vm_cpu_available(self, vm: VM) -> float:
        return sum(self.slot_cpu[s] for s in vm.slot_ids())

    def vm_mem_available(self, vm: VM) -> float:
        return sum(self.slot_mem[s] for s in vm.slot_ids())

    def mixed_slots(self) -> int:
        """Number of slots hosting threads of more than one task (SAM bounds
        this by |V|, §7.4)."""
        return sum(1 for counts in self.slot_task_counts().values()
                   if len(counts) > 1)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Mapping(threads={len(self.assignment)}, "
                f"slots={len(self.used_slots())}/{len(self.slots())})")


def make_threads(alloc: Allocation) -> List[Thread]:
    """Materialize the thread set R from an allocation."""
    threads: List[Thread] = []
    for name, ta in alloc.tasks.items():
        threads.extend(Thread(name, k) for k in range(ta.threads))
    return threads


# ---------------------------------------------------------------------------
# Algorithm 4: Default Storm Mapping (round-robin).
# ---------------------------------------------------------------------------

def map_dsm(dag: Dataflow, alloc: Allocation, vms: Sequence[VM],
            models: Optional[ModelLibrary] = None) -> Mapping:
    """Round-robin threads over slots, resource-oblivious (Alg. 4)."""
    mapping = Mapping(vms)
    slots = mapping.slots()
    threads = make_threads(alloc)
    for n, thread in enumerate(threads):
        mapping.assign(thread, slots[n % len(slots)])
    return mapping


# ---------------------------------------------------------------------------
# Algorithm 5: R-Storm Mapping (resource- and network-aware best fit).
# ---------------------------------------------------------------------------

def map_rsm(dag: Dataflow, alloc: Allocation, vms: Sequence[VM],
            models: ModelLibrary, *,
            w_cpu: float = 1.0, w_mem: float = 1.0, w_net: float = 1.0) -> Mapping:
    """R-Storm mapping (Alg. 5).

    One sweep maps one thread of every task in topological order; candidate
    VMs are sorted by the Euclidean distance between the VM's *available*
    resources and the thread's single-thread needs (``c_bar, m_bar``), plus a
    network term from the last-mapped VM.  Storm semantics: CPU% pools across
    a VM's slots, memory% binds per slot.
    """
    mapping = Mapping(vms)
    # Per-VM availability ARRAYS (Storm lets threads use any core of the VM,
    # so CPU% pools VM-wide).  The R-Storm candidate order for one thread is
    # then a single vectorized lexsort over these arrays instead of a Python
    # ``sorted`` whose key closure re-reads dicts per comparison — the old
    # inner sort cost O(V log V) *Python-object* work per thread.  A full
    # once-per-sweep hoist of the sort itself would change placements: the
    # distance depends on availability (updated by every assignment) and on
    # the last-mapped VM's network term, so the *order* is recomputed per
    # thread, but as one O(V) array pass.
    avail_cpu = np.array([vm.num_slots * 1.0 for vm in vms])
    avail_mem = np.array([vm.num_slots * vm.mem_per_slot for vm in vms])
    vm_ids = np.array([vm.id for vm in vms], dtype=int)
    vm_racks = np.array([vm.rack for vm in vms], dtype=int)
    remaining: Dict[str, int] = {n: ta.threads for n, ta in alloc.tasks.items()}
    next_idx: Dict[str, int] = {n: 0 for n in alloc.tasks}
    ref: Optional[VM] = vms[0] if vms else None
    order = [t.name for t in dag.topo_order()]
    # per-thread needs are rate-independent: hoist them out of the sweep loop
    needs: Dict[str, Tuple[float, float]] = {}
    for name, ta in alloc.tasks.items():
        model = models[ta.kind]
        if ta.bundle_size > 1:
            # MBA-style allocation: charge the model-amortized per-thread
            # resources at the bundle operating point (a 50-thread blob
            # bundle uses ~96% of a slot, not 50 x 23.9% — §8.5 maps
            # 25-30 such threads per slot under RSM)
            needs[name] = (model.C(ta.bundle_size) / ta.bundle_size,
                           model.M(ta.bundle_size) / ta.bundle_size)
        else:
            needs[name] = (model.C(1), model.M(1))

    while sum(remaining.values()) > 0:
        progressed = False
        for name in order:
            if remaining[name] <= 0:
                continue
            c_bar, m_bar = needs[name]
            # R-Storm distance on available resources, one array pass; the
            # lexsort (dist primary, VM id tiebreak) reproduces the old
            # ``sorted(vms, key=lambda v: (dist(v), v.id))`` order exactly
            if ref is None:
                net = np.zeros(len(vms))
            else:
                net = np.where(vm_ids == ref.id, 0.0,
                               np.where(vm_racks == ref.rack, 0.5, 1.0))
            d = (w_mem * (avail_mem - m_bar) ** 2
                 + w_cpu * (avail_cpu - c_bar) ** 2 + w_net * net)
            chosen_slot: Optional[SlotId] = None
            chosen_vm: Optional[VM] = None
            chosen_i = -1
            for i in np.lexsort((vm_ids, d)):
                if avail_cpu[i] + 1e-9 < c_bar:
                    continue
                vm = vms[i]
                # best-fit slot within the VM by remaining memory
                fitting = [s for s in vm.slot_ids()
                           if mapping.slot_mem[s] + 1e-9 >= m_bar]
                if not fitting:
                    continue
                chosen_slot = min(fitting, key=lambda s: (mapping.slot_mem[s], s.slot))
                chosen_vm = vm
                chosen_i = int(i)
                break
            if chosen_slot is None:
                raise InsufficientResourcesError(name)
            thread = Thread(name, next_idx[name])
            next_idx[name] += 1
            mapping.assign(thread, chosen_slot, cpu=0.0, mem=m_bar)
            avail_cpu[chosen_i] -= c_bar
            avail_mem[chosen_i] -= m_bar
            remaining[name] -= 1
            ref = chosen_vm
            progressed = True
        if not progressed:  # pragma: no cover - defensive
            raise InsufficientResourcesError("<any>", "no progress in RSM sweep")
    return mapping


# ---------------------------------------------------------------------------
# Algorithm 6: Slot-Aware Mapping (gang scheduling of thread bundles).
# ---------------------------------------------------------------------------

def _sam_bundle_plan(ta: TaskAllocation, models: ModelLibrary) -> Tuple[int, int, float, float]:
    """(bundle_size, full_bundles, partial_cpu, partial_mem) for a task.

    MBA allocations carry this directly; for other allocators (not used by
    the paper with SAM, but supported) it is derived from the model.
    """
    model = models[ta.kind]
    if ta.bundle_size > 0:  # MBA bookkeeping
        partial_cpu = ta.cpu - ta.full_bundles * 1.0
        partial_mem = ta.mem - ta.full_bundles * 1.0
        return ta.bundle_size, ta.full_bundles, max(0.0, partial_cpu), max(0.0, partial_mem)
    tau_hat = model.tau_hat
    full = ta.threads // tau_hat
    rem = ta.threads - full * tau_hat
    return tau_hat, full, (model.C(rem) if rem else 0.0), (model.M(rem) if rem else 0.0)


def map_sam(dag: Dataflow, alloc: Allocation, vms: Sequence[VM],
            models: ModelLibrary) -> Mapping:
    """Slot-Aware Mapping (Alg. 6).

    Full bundles of ``tau_hat`` threads are gang-mapped to *exclusive* empty
    slots (the bundle saturates the slot by construction, so it is charged
    100/100); the final partial bundle best-fits into a partially used slot.
    At most one partial bundle per task ever shares a slot, bounding
    mixed-task slots.
    """
    mapping = Mapping(vms)
    next_idx: Dict[str, int] = {n: 0 for n in alloc.tasks}
    plans = {n: _sam_bundle_plan(ta, models) for n, ta in alloc.tasks.items()}
    # Full bundles (slot-saturating, charged 100/100 by MBA) go to exclusive
    # slots; everything else is the partial bundle with its model-derived
    # residual charge.  Keying off the allocation's bundle bookkeeping (not
    # a bare tau_i >= tau_hat test) keeps trailing sub-peak thread groups
    # out of exclusive slots.
    remaining_full: Dict[str, int] = {n: plans[n][1] for n in alloc.tasks}
    partial_threads: Dict[str, int] = {
        n: alloc.tasks[n].threads - plans[n][1] * plans[n][0]
        for n in alloc.tasks}
    partial_need: Dict[str, Tuple[float, float]] = {
        n: (plans[n][2], plans[n][3]) for n in alloc.tasks}
    order = [t.name for t in dag.topo_order()]
    slot_list = mapping.slots()
    cursor = 0  # GetNextFullSlot scans forward from the last exclusive slot

    def next_full_slot() -> Optional[SlotId]:
        nonlocal cursor
        for k in range(len(slot_list)):
            s = slot_list[(cursor + k) % len(slot_list)]
            if mapping.slot_cpu[s] >= 1.0 - 1e-9 and not mapping.threads_on_slot(s):
                cursor = (cursor + k) % len(slot_list)
                return s
        return None

    def best_fit_slot(cpu: float, mem: float) -> Optional[SlotId]:
        fitting = [s for s in slot_list
                   if mapping.slot_cpu[s] + 1e-9 >= cpu
                   and mapping.slot_mem[s] + 1e-9 >= mem]
        if not fitting:
            return None
        return min(fitting, key=lambda s: (mapping.slot_cpu[s] + mapping.slot_mem[s],
                                           s.vm, s.slot))

    while sum(remaining_full.values()) + sum(partial_threads.values()) > 0:
        progressed = False
        for name in order:
            bundle, _, _, _ = plans[name]
            if remaining_full[name] > 0:
                s = next_full_slot()
                if s is None:
                    raise InsufficientResourcesError(name)
                for _ in range(bundle):
                    mapping.assign(Thread(name, next_idx[name]), s)
                    next_idx[name] += 1
                # the bundle owns the slot outright
                mapping.slot_cpu[s] = 0.0
                mapping.slot_mem[s] = 0.0
                remaining_full[name] -= 1
                progressed = True
            elif partial_threads[name] > 0:
                cpu, mem = partial_need[name]
                s = best_fit_slot(cpu, mem)
                if s is None:
                    raise InsufficientResourcesError(name)
                for _ in range(partial_threads[name]):
                    mapping.assign(Thread(name, next_idx[name]), s)
                    next_idx[name] += 1
                mapping.slot_cpu[s] -= cpu
                mapping.slot_mem[s] -= mem
                partial_threads[name] = 0
                progressed = True
        if not progressed:  # pragma: no cover - defensive
            raise InsufficientResourcesError("<any>", "no progress in SAM sweep")
    return mapping


MAPPERS = {
    "dsm": map_dsm,
    "rsm": map_rsm,
    "sam": map_sam,
}


# ---------------------------------------------------------------------------
# Candidate-mapping helpers for the simulation-guided search (repro.core.search).
# ---------------------------------------------------------------------------

def remap_threads(mapping: Mapping,
                  assignment: TMapping[Thread, SlotId]) -> Mapping:
    """A fresh :class:`Mapping` on the same VM pool with the given
    thread→slot assignment.

    The residual cpu/mem bookkeeping is NOT reconstructed (it is
    mapper-specific accounting); consumers of a *finished* mapping — the
    predictor, simulator, and search evaluator — read only ``vms`` and the
    assignment/co-location views.
    """
    out = Mapping(mapping.vms)
    for thread, slot in assignment.items():
        out.assign(thread, slot)
    return out


def mapping_signature(mapping: Mapping) -> Tuple:
    """Canonical co-location signature, invariant to slot renaming within a
    VM: per used slot, ``(vm id, sorted (task, count) contents)``, sorted.
    Two mappings with equal signatures are physically indistinguishable to
    the predictor and simulator (same groups, same co-location, same hop
    structure), so the candidate pool dedupes on it."""
    return tuple(sorted(
        (slot.vm, tuple(sorted(counts.items())))
        for slot, counts in mapping.slot_task_counts().items()))


def local_moves(mapping: Mapping, *, n_moves: int = 8, seed: int = 0,
                max_tries: Optional[int] = None) -> List[Mapping]:
    """Seeded local perturbations of a base mapping: *swap* the whole thread
    contents of two used slots (preferring cross-VM pairs — same-VM swaps
    are physically identity moves and dedupe away), or *migrate* one task's
    thread bundle to an empty slot.

    Both move kinds preserve every per-(task, slot) group size, so all
    candidates derived from one base share the base's group-shape signature
    — the property the search's shape-bucketed vmap evaluation relies on to
    batch them into ONE compiled kernel.  Returns up to ``n_moves`` distinct
    (by :func:`mapping_signature`) new mappings.
    """
    rng = random.Random(seed)
    out: List[Mapping] = []
    seen = {mapping_signature(mapping)}
    used = mapping.used_slots()
    used_set = set(used)
    empty = [s for s in mapping.slots() if s not in used_set]
    tries = max_tries if max_tries is not None else max(20, n_moves * 20)
    for _ in range(tries):
        if len(out) >= n_moves:
            break
        assignment = dict(mapping.assignment)
        if empty and (len(used) < 2 or rng.random() < 0.5):
            # migrate one (task, slot) bundle to an empty slot
            src = rng.choice(used)
            tasks_on = sorted({t.task for t in mapping.threads_on_slot(src)})
            task = rng.choice(tasks_on)
            dst = rng.choice(empty)
            for t in mapping.threads_on_slot(src):
                if t.task == task:
                    assignment[t] = dst
        elif len(used) >= 2:
            # swap two used slots' whole contents, biased to cross-VM pairs
            a, b = rng.sample(used, 2)
            if a.vm == b.vm:
                cross = [s for s in used if s.vm != a.vm]
                if cross:
                    b = rng.choice(cross)
            for t, s in mapping.assignment.items():
                if s == a:
                    assignment[t] = b
                elif s == b:
                    assignment[t] = a
        else:
            break   # single used slot and nowhere to move: no moves exist
        cand = remap_threads(mapping, assignment)
        sig = mapping_signature(cand)
        if sig in seen:
            continue
        seen.add(sig)
        out.append(cand)
    return out
