"""Model-based prediction of schedule behaviour (paper §8.5).

Given *any* thread→slot mapping (not only SAM's), the performance models
predict:

* the peak input rate the schedule sustains (Fig. 10),
* per-slot and per-VM CPU% / memory% at a given running rate (Figs. 11–12).

The per-slot-group capacity rule is the paper's (§8.4.1): a group of ``q``
threads of task ``t`` on one slot supports ``I_t(q)``; a task's capacity is
the sum over its groups; e.g. 2+2+2+2+9 Azure-Table threads across 5 slots
give ``4*I(2) + I(9)``.

Everything rate-independent about a schedule is precomputed once into a
:class:`GroupIndex`; the predictors are then pure array passes over it —
:func:`predict_resources_sweep` evaluates the §8.5.2 CPU/mem surfaces for a
whole rate sweep at once (``(S, K)`` / ``(V, K)``), and
:func:`predict_max_rate_gi` reduces the peak-rate question to one min over
groups (plus an :func:`effective_capacity_matrix` sweep when the §8.4.2
oversubscription penalty makes capacity rate-dependent).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .allocation import Allocation
from .dag import Dataflow, Routing
from .mapping import Mapping as ThreadMapping, SlotId, VM
from .perfmodel import ModelLibrary
from .routing import RoutingPolicy, group_rates

#: CPU oversubscription penalty (§8.4.2): Storm pools CPU% across a VM, so
#: resource-aware mappers can stack compute-heavy threads past a slot's core;
#: the slot's single worker thread then throttles routing.  When the
#: rate-scaled CPU on one slot exceeds 100%, capacity scales by 1/over-use.
#: The §8.5 *predictor* does NOT model this (the paper's doesn't either —
#: it is one source of its prediction error); the *simulator* does.
CPU_OVERSUB_PENALTY = False


def slot_groups(mapping: ThreadMapping, alloc: Allocation
                ) -> Dict[str, Dict[SlotId, int]]:
    """task -> {slot -> thread count} from a mapping."""
    per_slot = mapping.slot_task_counts()
    out: Dict[str, Dict[SlotId, int]] = {name: {} for name in alloc.tasks}
    for slot, counts in per_slot.items():
        for task, q in counts.items():
            out[task][slot] = q
    return out


@dataclasses.dataclass
class GroupIndex:
    """Flat-array view of a schedule's (task, slot) thread groups.

    Everything rate-*independent* about a mapping is precomputed once here:
    group membership, per-group thread counts and model capacities, routing
    fractions (thread- or capacity-proportional — both are independent of the
    operating rate), slot segmentation, and the DAG's linear rate
    coefficients.  The batch predictor and the sweep simulator then evaluate
    any vector of input rates as pure array passes over this index.

    Shapes: ``T`` tasks (DAG topo order), ``G`` groups, ``S`` slots.
    """

    tasks: List[str]                 # (T,) topo order
    task_of: Dict[str, int]
    betas: np.ndarray                # (T,) per-task rate per unit DAG rate
    task_start: np.ndarray           # (T+1,) group-slice offsets per task
    g_task: np.ndarray               # (G,) owning task row per group
    g_slot: np.ndarray               # (G,) slot index per group
    g_threads: np.ndarray            # (G,) thread count per group
    g_cap: np.ndarray                # (G,) model peak rate I_t(q)
    g_cpu: np.ndarray                # (G,) model CPU% C_t(q)
    g_mem: np.ndarray                # (G,) model memory% M_t(q)
    g_frac: np.ndarray               # (G,) routing fraction within the task
    slots: List[SlotId]              # (S,)
    in_edges: List[List[Tuple[int, float]]]  # per task: (src row, multiplier)

    @property
    def n_groups(self) -> int:
        return len(self.g_task)

    def task_slice(self, row: int) -> slice:
        return slice(self.task_start[row], self.task_start[row + 1])

    def row_slices(self) -> List[Tuple[int, int]]:
        """Per task row, the contiguous ``(start, stop)`` group span — the
        gather layout the sweep engines' tick kernels are built from."""
        return [(int(self.task_start[r]), int(self.task_start[r + 1]))
                for r in range(len(self.tasks))]


def build_group_index(dag: Dataflow, alloc: Allocation,
                      mapping: ThreadMapping, models: ModelLibrary,
                      policy: RoutingPolicy = RoutingPolicy.SHUFFLE
                      ) -> GroupIndex:
    """Flatten ``slot_groups`` into contiguous arrays, tasks in topo order.

    Heterogeneous pools fold in here once: a group's capacity is the model
    peak rate ``I_t(q)`` scaled by its slot's VM speed, so every consumer of
    ``g_cap`` (batch predictor, sweep simulator, rate prover) is speed-aware
    without further changes.  Unit-speed VMs scale by exactly 1.0."""
    vm_speed = {vm.id: vm.speed for vm in getattr(mapping, "vms", ())}
    groups = slot_groups(mapping, alloc)
    order = [t.name for t in dag.topo_order()]
    task_of = {name: i for i, name in enumerate(order)}
    betas_map = dag.get_rates(1.0)
    slots: List[SlotId] = []
    slot_of: Dict[SlotId, int] = {}
    task_start = [0]
    g_task: List[int] = []
    g_slot: List[int] = []
    g_threads: List[int] = []
    g_cap: List[float] = []
    g_cpu: List[float] = []
    g_mem: List[float] = []
    g_frac: List[float] = []
    for row, name in enumerate(order):
        g = groups.get(name, {})
        kind = alloc.tasks[name].kind
        model = models[kind]
        if g:
            # unit task rate: fractions are rate-independent under both
            # policies (thread- resp. capacity-proportional)
            dist = group_rates(name, kind, 1.0, g, models, policy)
        for slot, q in g.items():
            if slot not in slot_of:
                slot_of[slot] = len(slots)
                slots.append(slot)
            g_task.append(row)
            g_slot.append(slot_of[slot])
            g_threads.append(q)
            g_cap.append(model.I(q) * vm_speed.get(slot.vm, 1.0))
            g_cpu.append(model.C(q))
            g_mem.append(model.M(q))
            g_frac.append(dist[slot])
        task_start.append(len(g_task))
    in_edges: List[List[Tuple[int, float]]] = []
    for name in order:
        meta = []
        for e in dag.in_edges(name):
            mult = e.selectivity
            outs = len(dag.out_edges(e.src))
            if dag.routing[e.src] is Routing.SPLIT and outs:
                mult /= outs
            meta.append((task_of[e.src], mult))
        in_edges.append(meta)
    return GroupIndex(
        tasks=order, task_of=task_of,
        betas=np.array([betas_map[n] for n in order]),
        task_start=np.array(task_start),
        g_task=np.array(g_task, dtype=int), g_slot=np.array(g_slot, dtype=int),
        g_threads=np.array(g_threads, dtype=int),
        g_cap=np.array(g_cap), g_cpu=np.array(g_cpu), g_mem=np.array(g_mem),
        g_frac=np.array(g_frac), slots=slots, in_edges=in_edges)


def effective_capacity_matrix(gi: GroupIndex, omegas: np.ndarray,
                              *, cpu_penalty: bool = CPU_OVERSUB_PENALTY,
                              iters: int = 8) -> np.ndarray:
    """Per-(group, rate) sustainable rate, vectorized over a rate sweep.

    The array form of :func:`effective_capacities`: base capacity is the
    model's ``I_t(q)`` per group; with ``cpu_penalty`` the §8.4.2 throttle is
    found by the same damped fixed point, but evaluated for every rate in
    ``omegas`` at once (shape ``(G, K)``).  Each step averages the previous
    estimate with the throttle target — the undamped update oscillates
    between throttled and unthrottled whenever serving the *throttled* rate
    fits the slot's core again (two tasks sharing one slot near saturation).
    """
    omegas = np.asarray(omegas, dtype=float)
    caps = np.repeat(gi.g_cap[:, None], len(omegas), axis=1)
    if not cpu_penalty or gi.n_groups == 0:
        return caps
    base = gi.g_cap[:, None]
    arr = gi.g_frac[:, None] * gi.betas[gi.g_task][:, None] * omegas[None, :]
    n_slots = len(gi.slots)
    for _ in range(iters):
        served = np.minimum(arr, caps)
        frac_used = np.where(base > 0, np.minimum(1.0, served / np.where(
            base > 0, base, 1.0)), 1.0)
        used = gi.g_cpu[:, None] * frac_used
        slot_cpu = np.zeros((n_slots, len(omegas)))
        np.add.at(slot_cpu, gi.g_slot, used)
        over = slot_cpu[gi.g_slot]
        target = np.where(over > 1.0 + 1e-9, base / over, base)
        caps = 0.5 * (caps + target)
    return caps


def effective_capacities(dag: Dataflow, alloc: Allocation,
                         mapping: ThreadMapping, models: ModelLibrary,
                         *, cpu_penalty: bool = CPU_OVERSUB_PENALTY,
                         omega: Optional[float] = None,
                         policy=None, iters: int = 8
                         ) -> Dict[str, Dict[SlotId, float]]:
    """Per-(task, slot) sustainable rate.

    With ``cpu_penalty`` (simulator mode) the §8.4.2 throttle is applied:
    the rate-scaled CPU draw of all groups sharing a slot is summed and, if
    it exceeds the slot's core, every group's capacity scales by the
    over-use factor.  Rate-scaling needs the operating rate; pass ``omega``
    (and optionally a routing policy) — the fixed point is found by a few
    damped iterations.  Without the penalty this is just ``I_t(q)``.
    """
    from .routing import RoutingPolicy, group_rates
    groups = slot_groups(mapping, alloc)
    caps: Dict[str, Dict[SlotId, float]] = {
        t: {s: models[alloc.tasks[t].kind].I(q) for s, q in g.items()}
        for t, g in groups.items()}
    if not cpu_penalty:
        return caps
    policy = policy or RoutingPolicy.SHUFFLE
    rates = dag.get_rates(omega) if omega is not None else None
    for _ in range(iters):
        # rate-scaled CPU draw per slot at the current capacity estimate
        slot_cpu: Dict[SlotId, float] = {}
        for task, g in groups.items():
            kind = alloc.tasks[task].kind
            model = models[kind]
            if rates is not None:
                arr = group_rates(task, kind, rates[task], g, models, policy)
            for slot, q in g.items():
                peak = model.I(q)
                if rates is None or peak <= 0:
                    used = model.C(q)
                else:
                    served = min(arr[slot], caps[task][slot])
                    used = model.C(q) * min(1.0, served / peak)
                slot_cpu[slot] = slot_cpu.get(slot, 0.0) + used
        nxt: Dict[str, Dict[SlotId, float]] = {}
        for task, g in groups.items():
            kind = alloc.tasks[task].kind
            model = models[kind]
            nxt[task] = {}
            for slot, q in g.items():
                cap = model.I(q)
                over = slot_cpu.get(slot, 0.0)
                if over > 1.0 + 1e-9:
                    cap /= over
                # rate-scaled updates are damped like the matrix form (the
                # raw update oscillates when the throttled rate fits the
                # core again); the full-C target is constant, so the plain
                # update reaches it exactly
                if rates is None:
                    nxt[task][slot] = cap
                else:
                    nxt[task][slot] = 0.5 * (caps[task][slot] + cap)
        caps = nxt
    return caps


def predict_max_rate_gi(gi: GroupIndex, *,
                        cpu_penalty: bool = CPU_OVERSUB_PENALTY,
                        grid_points: int = 256) -> float:
    """Largest DAG input rate Omega* a prebuilt :class:`GroupIndex` sustains.

    Per group the demand is ``frac * beta * Omega`` and the binding
    constraint ``demand <= capacity``; the worst group over all tasks caps
    Omega.  Routing policy is baked into ``g_frac`` (threads-proportional for
    shuffle, capacity-proportional for slot-aware), so one min over groups
    covers both cases.

    With ``cpu_penalty`` the capacity itself depends on the operating rate
    (§8.4.2: rate-scaled CPU draw of co-located groups throttles the slot),
    so the closed form becomes a feasibility sweep: evaluate
    :func:`effective_capacity_matrix` over a rate grid up to the penalty-free
    optimum in one array pass and keep the largest rate every group serves.
    """
    demand = gi.g_frac * gi.betas[gi.g_task]     # per unit DAG rate
    binding = demand > 0
    if not np.any(binding):
        return float("inf")
    omega_free = float(np.min(gi.g_cap[binding] / demand[binding]))
    if not cpu_penalty or omega_free <= 0:
        return omega_free
    omegas = np.linspace(0.0, omega_free, grid_points + 1)[1:]
    caps = effective_capacity_matrix(gi, omegas, cpu_penalty=True)
    ok = np.all(demand[binding, None] * omegas[None, :]
                <= caps[binding] * (1 + 1e-9), axis=0)
    n = int(np.flatnonzero(~ok)[0]) if not ok.all() else len(ok)
    return float(omegas[n - 1]) if n else 0.0


def predict_max_rate(dag: Dataflow, alloc: Allocation, mapping: ThreadMapping,
                     models: ModelLibrary,
                     policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
                     *, cpu_penalty: bool = CPU_OVERSUB_PENALTY) -> float:
    """Largest DAG input rate Omega* the schedule sustains under ``policy``.

    Task rates are linear in Omega (``rate_t = beta_t * Omega``), so under
    slot-aware routing the binding constraint per task is its total capacity;
    under shuffle routing it is the *worst* group, which receives threads-
    proportional input regardless of its capacity.  With ``cpu_penalty`` the
    §8.4.2 throttle is evaluated at the candidate rate (rate-scaled CPU
    draw), not the groups' full ``C(q)`` — see :func:`predict_max_rate_gi`.
    """
    gi = build_group_index(dag, alloc, mapping, models, policy)
    return predict_max_rate_gi(gi, cpu_penalty=cpu_penalty)


@dataclasses.dataclass
class ResourcePrediction:
    """Predicted CPU%/mem% per slot and per VM at a given DAG rate."""

    omega: float
    slot_cpu: Dict[SlotId, float]
    slot_mem: Dict[SlotId, float]
    vm_cpu: Dict[int, float]
    vm_mem: Dict[int, float]


def predict_resources(dag: Dataflow, alloc: Allocation, mapping: ThreadMapping,
                      models: ModelLibrary, omega: float,
                      policy: RoutingPolicy = RoutingPolicy.SHUFFLE
                      ) -> ResourcePrediction:
    """Predict resource usage at DAG input rate ``omega`` (§8.5.2).

    A group of ``q`` threads receiving ``r <= I(q)`` is charged
    ``C(q) * r / I(q)`` (the paper's proportional scale-down); at or above
    peak it is charged the full ``C(q)/M(q)``.
    """
    rates = dag.get_rates(omega)
    groups = slot_groups(mapping, alloc)
    slot_cpu: Dict[SlotId, float] = {s: 0.0 for s in mapping.slots()}
    slot_mem: Dict[SlotId, float] = {s: 0.0 for s in mapping.slots()}
    for task, g in groups.items():
        kind = alloc.tasks[task].kind
        model = models[kind]
        incoming = group_rates(task, kind, rates[task], g, models, policy)
        for slot, q in g.items():
            peak = model.I(q)
            frac = 1.0 if peak <= 0 else min(1.0, incoming[slot] / peak)
            slot_cpu[slot] += model.C(q) * frac
            slot_mem[slot] += model.M(q) * frac
    vm_cpu: Dict[int, float] = {}
    vm_mem: Dict[int, float] = {}
    for vm in mapping.vms:
        vm_cpu[vm.id] = sum(slot_cpu[s] for s in vm.slot_ids())
        vm_mem[vm.id] = sum(slot_mem[s] for s in vm.slot_ids())
    return ResourcePrediction(omega, slot_cpu, slot_mem, vm_cpu, vm_mem)


@dataclasses.dataclass
class ResourceSweep:
    """Predicted CPU%/mem% surfaces over a whole rate sweep.

    ``slot_cpu``/``slot_mem`` have shape ``(S, K)`` (row order ``slots``);
    ``vm_cpu``/``vm_mem`` have shape ``(V, K)`` (row order ``vm_ids``).
    """

    omegas: np.ndarray
    slots: List[SlotId]
    vm_ids: List[int]
    slot_cpu: np.ndarray
    slot_mem: np.ndarray
    vm_cpu: np.ndarray
    vm_mem: np.ndarray

    def at(self, k: int) -> ResourcePrediction:
        """Dict view of one sweep column (the scalar prediction's shape)."""
        return ResourcePrediction(
            float(self.omegas[k]),
            {s: float(self.slot_cpu[i, k]) for i, s in enumerate(self.slots)},
            {s: float(self.slot_mem[i, k]) for i, s in enumerate(self.slots)},
            {v: float(self.vm_cpu[i, k]) for i, v in enumerate(self.vm_ids)},
            {v: float(self.vm_mem[i, k]) for i, v in enumerate(self.vm_ids)})


def predict_resources_sweep(gi: GroupIndex, omegas: Sequence[float],
                            *, mapping: Optional[ThreadMapping] = None
                            ) -> ResourceSweep:
    """Vectorized §8.5.2 resource prediction: every rate in ``omegas`` in one
    array pass over a prebuilt :class:`GroupIndex`.

    A group of ``q`` threads receiving ``r <= I(q)`` is charged
    ``C(q) * r / I(q)`` (the paper's proportional scale-down), full
    ``C(q)/M(q)`` at or above peak — identical to per-rate
    :func:`predict_resources` calls, as one ``(G, K)`` pass.

    ``mapping`` (optional) extends the reported rows to the mapping's full
    slot/VM inventory — unused slots predict 0.0, matching the scalar path;
    without it only slots hosting threads appear.
    """
    omegas = np.asarray(omegas, dtype=float)
    K = len(omegas)
    slots = list(gi.slots)
    slot_of = {s: i for i, s in enumerate(slots)}
    g_slot = gi.g_slot
    if mapping is not None:
        extra = [s for s in mapping.slots() if s not in slot_of]
        for s in extra:
            slot_of[s] = len(slots)
            slots.append(s)
    incoming = gi.g_frac[:, None] * gi.betas[gi.g_task][:, None] \
        * omegas[None, :]
    safe_cap = np.where(gi.g_cap > 0, gi.g_cap, 1.0)
    frac = np.where(gi.g_cap[:, None] > 0,
                    np.minimum(1.0, incoming / safe_cap[:, None]), 1.0)
    slot_cpu = np.zeros((len(slots), K))
    slot_mem = np.zeros((len(slots), K))
    np.add.at(slot_cpu, g_slot, gi.g_cpu[:, None] * frac)
    np.add.at(slot_mem, g_slot, gi.g_mem[:, None] * frac)
    if mapping is not None:
        vm_ids = [vm.id for vm in mapping.vms]
    else:
        vm_ids = sorted({s.vm for s in slots})
    vm_of = {v: i for i, v in enumerate(vm_ids)}
    vm_rows = np.array([vm_of[s.vm] for s in slots], dtype=int)
    vm_cpu = np.zeros((len(vm_ids), K))
    vm_mem = np.zeros((len(vm_ids), K))
    np.add.at(vm_cpu, vm_rows, slot_cpu)
    np.add.at(vm_mem, vm_rows, slot_mem)
    return ResourceSweep(omegas, slots, vm_ids, slot_cpu, slot_mem,
                         vm_cpu, vm_mem)
