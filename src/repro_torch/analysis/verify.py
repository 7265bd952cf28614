"""Plan-artifact invariant verifier: the passes the port's planner calls.

A copy of the JAX package's ``analysis/verify.py`` (numpy and the port's
``core`` only), holding just the passes that ``plan(validate=...)``,
``plan_fleet``/``replan_incremental`` and the online controller call:
:func:`verify_dag`, :func:`verify_allocation`, :func:`verify_schedule`
(with ``_verify_group_index``), :func:`verify_fleet_plan` (with
``_spot_check_surface`` and the :func:`verify_grid` it runs),
:func:`verify_rate_decisions`, :func:`verify_trace` and
:func:`verify_controller`, the model-table pass :func:`verify_models`,
and the runtime's passes: :func:`verify_enactment` (the ``LiveFleet``
hook), :func:`verify_calibration` (``recalibrate``'s),
:func:`verify_tracer` and :func:`verify_autorecal`.  Each pass returns a list of
:class:`~repro_torch.core.diagnostics.Violation`\\ s (empty = clean),
with the reference's codes (``docs/INVARIANTS.md``).

Design rules:

* **array-level, not re-planning** — a pass inspects the artifact it is
  handed (set algebra over thread/VM ids, ``np.diff`` over slot surfaces);
  it never re-runs an allocator or mapper unless explicitly asked to
  (``deep=True`` spot-checks a few
  :func:`~repro_torch.core.batch.batch_slots` cells against the cached
  surface).
* **no raising mid-pass** — passes collect; the planner hooks raise via
  :func:`~repro_torch.core.diagnostics.raise_if_errors` on ERROR severity
  only.
* **guarded delegation** — :func:`verify_controller` checks structural key
  agreement before materializing ``controller.plan`` (a corrupted
  controller must produce a Violation, not a ``KeyError``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from ..core.dag import Dataflow
from ..core.diagnostics import Severity, Violation
from ..core.mapping import make_threads
from ..core.perfmodel import ModelLibrary, PerfModel

#: Relative tolerance for float identities (rates, fractions).
REL_TOL = 1e-6
#: Slot-surface cells at or above this are the batch engine's
#: unsupportable-rate clip (2**62), not real slot counts.
CLIP_SENTINEL = 2.0 ** 61


def _v(code: str, sev: Severity, artifact: str, path: str,
       detail: str) -> Violation:
    return Violation(code, sev, artifact, path, detail)


def _close(a: float, b: float, tol: float = REL_TOL) -> bool:
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


# ---------------------------------------------------------------------------
# DAG (paper §3: G=(T,E) with selectivities; §6 rate recurrence).
# ---------------------------------------------------------------------------

def verify_dag(dag: Dataflow) -> List[Violation]:
    """Structural soundness of a :class:`Dataflow`."""
    art = f"Dataflow[{dag.name}]"
    out: List[Violation] = []
    if not dag.tasks:
        out.append(_v("DAG_NO_TASKS", Severity.ERROR, art, "tasks",
                      "dataflow has no tasks"))
        return out
    for i, e in enumerate(dag.edges):
        for endpoint in (e.src, e.dst):
            if endpoint not in dag.tasks:
                out.append(_v("DAG_EDGE_UNKNOWN_TASK", Severity.ERROR, art,
                              f"edges[{i}]",
                              f"edge {e.src!r}->{e.dst!r} references unknown "
                              f"task {endpoint!r}"))
        if not (np.isfinite(e.selectivity) and e.selectivity > 0):
            out.append(_v("DAG_BAD_SELECTIVITY", Severity.ERROR, art,
                          f"edges[{i}]",
                          f"edge {e.src!r}->{e.dst!r} selectivity "
                          f"{e.selectivity!r} must be positive and finite"))
    # Kahn over the known-endpoint edges; do not call topo_order() (it
    # raises — a verifier reports).
    known = [e for e in dag.edges
             if e.src in dag.tasks and e.dst in dag.tasks]
    indeg = {n: 0 for n in dag.tasks}
    for e in known:
        indeg[e.dst] += 1
    ready = [n for n, d in indeg.items() if d == 0]
    seen = 0
    while ready:
        n = ready.pop()
        seen += 1
        for e in known:
            if e.src == n:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
    if seen != len(dag.tasks):
        cyclic = sorted(n for n, d in indeg.items() if d > 0)
        out.append(_v("DAG_CYCLE", Severity.ERROR, art, "edges",
                      f"cycle through tasks {cyclic}"))
    have_in = {e.dst for e in known}
    have_out = {e.src for e in known}
    for t in dag.tasks.values():
        if t.is_source and t.name in have_in:
            out.append(_v("DAG_ENDPOINT_FLAG", Severity.ERROR, art,
                          f"tasks[{t.name!r}]",
                          "flagged is_source but has in-edges"))
        if t.is_sink and t.name in have_out:
            out.append(_v("DAG_ENDPOINT_FLAG", Severity.ERROR, art,
                          f"tasks[{t.name!r}]",
                          "flagged is_sink but has out-edges"))
        if t.name not in dag.routing:
            out.append(_v("DAG_ROUTING_MISSING", Severity.ERROR, art,
                          f"routing[{t.name!r}]",
                          "task has no outgoing-edge routing semantics"))
    return out


# ---------------------------------------------------------------------------
# Performance models (paper §5 profiles; §8.5 interpolation).
# ---------------------------------------------------------------------------

def verify_models(models: ModelLibrary,
                  kinds: Optional[Iterable[str]] = None,
                  grid: Optional[np.ndarray] = None) -> List[Violation]:
    """Profile-table soundness per :class:`PerfModel` (optionally only the
    ``kinds`` a DAG uses) plus, with ``grid``, planning-grid sanity.

    NOTE: the paper's own Fig. 3 tables are *not* rate- or CPU-monotone in
    tau (``parse_xml`` rates decline past the peak, ``batch_file_write``
    CPU dips) — monotonicity of the measured columns is deliberately NOT
    an invariant; strict tau ordering and positivity are."""
    out: List[Violation] = []
    for kind in (sorted(kinds) if kinds is not None else models.kinds()):
        model: PerfModel = models[kind]
        art = f"PerfModel[{kind}]"
        xp = np.asarray(model._xp, dtype=float)
        if len(xp) < 2 or not np.all(np.diff(xp) > 0) or xp[0] != 0.0:
            out.append(_v("MOD_TAU_ORDER", Severity.ERROR, art, "_xp",
                          "thread-count table must be the (0,0) anchor "
                          "followed by strictly increasing taus; got "
                          f"{xp.tolist()}"))
        for field, fp in model._fp.items():
            fp = np.asarray(fp, dtype=float)
            if not np.all(np.isfinite(fp)) or np.any(fp < 0):
                out.append(_v("MOD_NEGATIVE", Severity.ERROR, art,
                              f"_fp[{field!r}]",
                              f"{field} column must be finite and >= 0; "
                              f"got {fp.tolist()}"))
        for p in model.points:
            # a profile point measures ONE slot; >100% of it is suspect
            # (paper §5) but tables are measured data: warn, don't fail
            if p.cpu > 1.0 + 1e-9 or p.mem > 1.0 + 1e-9:
                out.append(_v("MOD_RES_OVER_SLOT", Severity.WARNING, art,
                              f"points[tau={p.tau}]",
                              f"cpu={p.cpu:g} mem={p.mem:g} exceed one slot"))
        if not model.static and model.omega_hat <= 0:
            out.append(_v("MOD_ZERO_PEAK", Severity.ERROR, art, "points",
                          "non-static model supports no rate at any thread "
                          "count (omega_hat <= 0)"))
    if grid is not None:
        out.extend(verify_grid(np.asarray(grid, dtype=float)))
    return out


def verify_grid(grid: np.ndarray, artifact: str = "grid") -> List[Violation]:
    """§8.5 planning-grid sanity: positive, finite, strictly increasing
    (the interpolation/bisection domain every surface row is indexed by)."""
    grid = np.asarray(grid, dtype=float)
    if (len(grid) == 0 or not np.all(np.isfinite(grid)) or grid[0] <= 0
            or np.any(np.diff(grid) <= 0)):
        return [_v("MOD_GRID_COVERAGE", Severity.ERROR, artifact, "grid",
                   "planning grid must be non-empty, positive, finite and "
                   "strictly increasing")]
    return []


# ---------------------------------------------------------------------------
# Allocation (paper §6, Algs. 2-3).
# ---------------------------------------------------------------------------

def verify_allocation(alloc, dag: Dataflow,
                      models: Optional[ModelLibrary] = None
                      ) -> List[Violation]:
    """Allocation↔DAG coherence: task set, kinds, §6 rate recurrence,
    thread positivity, MBA bundle bookkeeping."""
    art = f"Allocation[{alloc.dag}@{alloc.omega:g}]"
    out: List[Violation] = []
    if set(alloc.tasks) != set(dag.tasks):
        missing = sorted(set(dag.tasks) - set(alloc.tasks))
        extra = sorted(set(alloc.tasks) - set(dag.tasks))
        out.append(_v("ALC_TASK_MISMATCH", Severity.ERROR, art, "tasks",
                      f"allocation tasks disagree with DAG: missing="
                      f"{missing} extra={extra}"))
        return out
    try:
        want_rates = dag.get_rates(alloc.omega)
    except ValueError:
        want_rates = None                       # cyclic DAG: verify_dag owns it
    for name, ta in alloc.tasks.items():
        path = f"tasks[{name!r}]"
        if ta.kind != dag.tasks[name].kind:
            out.append(_v("ALC_KIND_MISMATCH", Severity.ERROR, art, path,
                          f"allocation kind {ta.kind!r} != DAG kind "
                          f"{dag.tasks[name].kind!r}"))
        is_static = bool(models and ta.kind in models
                         and models[ta.kind].static)
        if ta.threads < 0 or (ta.threads == 0 and not is_static
                              and ta.rate > 1e-9):
            out.append(_v("ALC_BAD_THREADS", Severity.ERROR, art, path,
                          f"{ta.threads} threads cannot sustain rate "
                          f"{ta.rate:g}"))
        if not (np.isfinite(ta.cpu) and np.isfinite(ta.mem)
                and ta.cpu >= 0 and ta.mem >= 0):
            out.append(_v("ALC_BAD_RESOURCES", Severity.ERROR, art, path,
                          f"cpu={ta.cpu!r} mem={ta.mem!r} must be finite "
                          "and >= 0"))
        if want_rates is not None and not _close(ta.rate, want_rates[name]):
            out.append(_v("ALC_RATE_MISMATCH", Severity.ERROR, art, path,
                          f"allocated rate {ta.rate:g} != §6 recurrence "
                          f"{want_rates[name]:g} at omega={alloc.omega:g}"))
        if (ta.full_bundles < 0 or ta.bundle_size < 0
                or ta.full_bundles * ta.bundle_size > ta.threads):
            out.append(_v("ALC_BUNDLE_BOOKKEEPING", Severity.ERROR, art, path,
                          f"{ta.full_bundles} bundles x {ta.bundle_size} "
                          f"threads exceed the {ta.threads} allocated"))
    return out


# ---------------------------------------------------------------------------
# Schedule (paper §7 mapping + §8.4 acquisition).
# ---------------------------------------------------------------------------

def verify_schedule(schedule, gi=None) -> List[Violation]:
    """Allocation↔mapping↔VM coherence of one :class:`Schedule`:

    every allocated thread placed exactly once, every placement on an
    acquired slot (§8.4 packing), VM ids unique, acquisition accounting
    exact, the mapping's internal slot indexes in sync, and — when the
    schedule's cached :class:`GroupIndex` is passed — group thread counts
    and routing fractions consistent with the mapping (§11 routing)."""
    art = f"Schedule[{schedule.dag.name}@{schedule.omega:g}]"
    out: List[Violation] = []
    # VM class soundness first: the speed-aware checks below lean on it
    speeds = set()
    mixed = False
    for i, vm in enumerate(schedule.vms):
        bad = []
        if not (np.isfinite(vm.speed) and vm.speed > 0):
            bad.append(f"speed={vm.speed!r}")
        if not (np.isfinite(vm.mem_per_slot) and vm.mem_per_slot > 0):
            bad.append(f"mem_per_slot={vm.mem_per_slot!r}")
        if vm.cost_per_hour is not None and not (
                np.isfinite(vm.cost_per_hour) and vm.cost_per_hour >= 0):
            bad.append(f"cost_per_hour={vm.cost_per_hour!r}")
        if bad:
            out.append(_v("RES_BAD_CLASS", Severity.ERROR, art, f"vms[{i}]",
                          f"VM {vm.id} has invalid class parameters: "
                          + ", ".join(bad)))
        else:
            speeds.add(vm.speed)
    if len(speeds) > 1:
        mixed = True
        out.append(_v("RES_MIXED_SPEED", Severity.ERROR, art, "vms",
                      f"pool mixes slot speeds {sorted(speeds)}; a DAG's "
                      "allocation assumes one uniform effective rate (§6)"))
    pool_spd = speeds.pop() if len(speeds) == 1 else 1.0
    if not np.isfinite(schedule.omega) or schedule.omega < 0:
        out.append(_v("SCH_BAD_OMEGA", Severity.ERROR, art, "omega",
                      f"planned rate {schedule.omega!r} must be finite "
                      "and >= 0"))
    elif not mixed and not _close(schedule.allocation.omega * pool_spd,
                                  schedule.omega):
        out.append(_v("SCH_ALLOC_OMEGA_MISMATCH", Severity.ERROR, art,
                      "allocation.omega",
                      f"schedule planned at {schedule.omega:g} but its "
                      f"allocation was computed at "
                      f"{schedule.allocation.omega:g} on a speed-"
                      f"{pool_spd:g} pool (expected effective rate "
                      f"omega/speed)"))
    vm_ids = [vm.id for vm in schedule.vms]
    if len(set(vm_ids)) != len(vm_ids):
        dups = sorted({i for i in vm_ids if vm_ids.count(i) > 1})
        out.append(_v("SCH_VM_DUP", Severity.ERROR, art, "vms",
                      f"duplicate VM ids {dups}"))
    total_slots = sum(vm.num_slots for vm in schedule.vms)
    if schedule.acquired_slots != total_slots:
        out.append(_v("SCH_ACQUIRED_MISMATCH", Severity.ERROR, art,
                      "acquired_slots",
                      f"acquired_slots={schedule.acquired_slots} but VMs "
                      f"hold {total_slots}"))
    if schedule.estimated_slots != schedule.allocation.slots:
        out.append(_v("SCH_ESTIMATE_MISMATCH", Severity.ERROR, art,
                      "estimated_slots",
                      f"estimated_slots={schedule.estimated_slots} but the "
                      f"allocation's rho={schedule.allocation.slots}"))
    expected = set(make_threads(schedule.allocation))
    mapped = set(schedule.mapping.assignment)
    for t in sorted(expected - mapped, key=repr):
        out.append(_v("SCH_THREAD_UNPLACED", Severity.ERROR, art,
                      f"mapping.assignment[{t!r}]",
                      "allocated thread has no slot"))
    for t in sorted(mapped - expected, key=repr):
        out.append(_v("SCH_THREAD_UNKNOWN", Severity.ERROR, art,
                      f"mapping.assignment[{t!r}]",
                      "mapped thread is not in the allocation"))
    sizes = {vm.id: vm.num_slots for vm in schedule.vms}
    for t, slot in schedule.mapping.assignment.items():
        if slot.vm not in sizes:
            out.append(_v("SCH_SLOT_UNKNOWN_VM", Severity.ERROR, art,
                          f"mapping.assignment[{t!r}]",
                          f"slot {slot!r} is on VM {slot.vm} which the "
                          "schedule does not own"))
        elif not (0 <= slot.slot < sizes[slot.vm]):
            out.append(_v("SCH_SLOT_OUT_OF_RANGE", Severity.ERROR, art,
                          f"mapping.assignment[{t!r}]",
                          f"slot index {slot.slot} outside VM {slot.vm}'s "
                          f"{sizes[slot.vm]} slots"))
    # the mapping's lazily-maintained slot indexes must agree with the
    # assignment (SAM's probes and the GroupIndex build read them)
    recount: Dict = {}
    for t, slot in schedule.mapping.assignment.items():
        counts = recount.setdefault(slot, {})
        counts[t.task] = counts.get(t.task, 0) + 1
    indexed = {s: dict(c) for s, c in schedule.mapping._slot_counts.items()
               if c}
    if indexed != recount:
        bad = sorted({repr(s) for s in
                      set(indexed) ^ set(recount)} |
                     {repr(s) for s in set(indexed) & set(recount)
                      if indexed[s] != recount[s]})
        out.append(_v("SCH_SLOT_INDEX_DESYNC", Severity.ERROR, art,
                      "mapping._slot_counts",
                      f"slot index disagrees with assignment at {bad}"))
    if gi is not None:
        out.extend(_verify_group_index(gi, schedule, art))
    return out


def _verify_group_index(gi, schedule, art: str) -> List[Violation]:
    """Cached :class:`GroupIndex` vs the live mapping: per-(task, slot)
    thread counts (§8.4.1 group capacity rule reads them) and routing
    fractions summing to 1 per task under the index's policy (§11)."""
    out: List[Violation] = []
    want: Dict = {}
    for t, slot in schedule.mapping.assignment.items():
        want[(t.task, slot)] = want.get((t.task, slot), 0) + 1
    got = {}
    for g in range(gi.n_groups):
        task = gi.tasks[int(gi.g_task[g])]
        slot = gi.slots[int(gi.g_slot[g])]
        got[(task, slot)] = got.get((task, slot), 0) + int(gi.g_threads[g])
    if got != want:
        bad = sorted({f"{t}@{s!r}" for (t, s) in set(got) ^ set(want)} |
                     {f"{t}@{s!r}" for (t, s) in set(got) & set(want)
                      if got[(t, s)] != want[(t, s)]})
        out.append(_v("SCH_GI_MISMATCH", Severity.ERROR, art,
                      "group_index.g_threads",
                      f"group thread counts disagree with the mapping at "
                      f"{bad}"))
    for row, task in enumerate(gi.tasks):
        sl = gi.task_slice(row)
        fracs = np.asarray(gi.g_frac[sl], dtype=float)
        if len(fracs) == 0:
            continue
        if (np.any(fracs < -REL_TOL) or np.any(fracs > 1 + REL_TOL)
                or not _close(float(fracs.sum()), 1.0)):
            out.append(_v("SCH_GI_FRAC", Severity.ERROR, art,
                          f"group_index.g_frac[{task}]",
                          f"routing fractions {fracs.tolist()} must lie in "
                          "[0,1] and sum to 1"))
    return out


# ---------------------------------------------------------------------------
# Fleet plan (multi-DAG disjointness over one budget).
# ---------------------------------------------------------------------------

def verify_fleet_plan(plan, models=None, *, deep: bool = False,
                      allocator: Optional[str] = None,
                      schedules_for: Optional[Iterable[str]] = None
                      ) -> List[Violation]:
    """Fleet-level disjointness and grid coherence of a :class:`FleetPlan`.

    ``deep=True`` additionally spot-checks a few cells of each DAG's cached
    slot-surface row against a fresh
    :func:`~repro_torch.core.batch.batch_slots` call (requires ``models``;
    the allocator defaults to the entries' schedules' allocator) — the
    :class:`SlotSurfaceCache` staleness check.

    ``schedules_for`` restricts the O(threads) per-schedule walks (and the
    per-row monotonicity/spot checks) to the named entries; fleet-wide VM
    disjointness, pool and budget accounting always cover everything.
    ``None`` (default) checks every entry.
    """
    from ..core.fleet import _models_for
    art = f"FleetPlan[{plan.objective}]"
    out: List[Violation] = list(verify_grid(plan.grid, art))
    grid_ok = not out
    walk = None if schedules_for is None else set(schedules_for)
    owner: Dict[int, str] = {}
    pool_want: List[int] = []
    cost_matrix = getattr(plan, "cost_matrix", None)
    # surface rows of a heterogeneous plan were computed at the classes'
    # speed/mem; the deep spot-check must recompute at the same point.
    # min_cost rows mix per-cell winning classes — no single class to
    # recompute with, so the spot-check is skipped there.
    spot_speed = spot_mem = 1.0
    spot_ok = cost_matrix is None
    classes = getattr(plan, "vm_classes", ())
    if spot_ok and classes:
        spds = {c.speed for c in classes}
        mems = {c.mem_per_slot for c in classes}
        if len(spds) == 1 and len(mems) == 1:
            spot_speed, spot_mem = spds.pop(), mems.pop()
        else:
            spot_ok = False
    dollars_total = 0.0
    for d, (name, e) in enumerate(plan.entries.items()):
        path = f"entries[{name!r}]"
        if e.grid_index >= 0:
            if grid_ok and (e.grid_index >= len(plan.grid) or
                            not _close(e.omega,
                                       float(plan.grid[e.grid_index]))):
                out.append(_v("FLT_GRID_MISMATCH", Severity.ERROR, art, path,
                              f"omega={e.omega:g} is not "
                              f"grid[{e.grid_index}]"))
            want = (int(plan.slots_matrix[d, e.grid_index])
                    if 0 <= e.grid_index < plan.slots_matrix.shape[1]
                    else None)
            if want is not None and e.estimated_slots != want:
                out.append(_v("FLT_SLOTS_MATRIX_MISMATCH", Severity.ERROR,
                              art, path,
                              f"estimated_slots={e.estimated_slots} but the "
                              f"surface row says {want}"))
            if (cost_matrix is not None
                    and 0 <= e.grid_index < cost_matrix.shape[1]):
                want_cost = float(cost_matrix[d, e.grid_index])
                dollars_total += e.est_cost_per_hour
                if not _close(e.est_cost_per_hour, want_cost):
                    out.append(_v("FLT_COST_MISMATCH", Severity.ERROR, art,
                                  path,
                                  f"est_cost_per_hour="
                                  f"${e.est_cost_per_hour:g}/h but the cost "
                                  f"surface says ${want_cost:g}/h at "
                                  f"grid[{e.grid_index}]"))
        else:
            if e.omega != 0.0 or e.estimated_slots != 0:
                out.append(_v("FLT_GRID_MISMATCH", Severity.ERROR, art, path,
                              f"grid_index=-1 requires omega=0/slots=0, got "
                              f"omega={e.omega:g} "
                              f"slots={e.estimated_slots}"))
        if e.omega <= 0 and e.schedule is not None:
            out.append(_v("FLT_ZERO_RATE_MAPPED", Severity.ERROR, art, path,
                          "zero-rate entry still holds a schedule/VMs"))
        if e.schedule is not None:
            for vm in e.schedule.vms:
                pool_want.append(vm.id)
                if vm.id in owner and owner[vm.id] != name:
                    out.append(_v("FLT_VM_DUP", Severity.ERROR, art, path,
                                  f"VM {vm.id} owned by both "
                                  f"{owner[vm.id]!r} and {name!r}"))
                owner.setdefault(vm.id, name)
            if walk is None or name in walk:
                out.extend(verify_schedule(e.schedule, gi=e.group_index))
        if walk is not None and name not in walk:
            continue
        # surface-row monotonicity within the un-clipped prefix (the level
        # bisection / water-fill correctness assumption, §8.5).  min_cost
        # selects over the COST surface — the best-class slot row may dip
        # where the winning class switches, so the cost row carries the
        # monotonicity contract there.
        row = np.asarray(plan.slots_matrix[d], dtype=np.int64)
        finite = row < CLIP_SENTINEL
        prefix = int(np.argmin(finite)) if not finite.all() else len(row)
        if cost_matrix is not None:
            crow = np.asarray(cost_matrix[d], dtype=float)
            cfin = np.isfinite(crow)
            cpre = int(np.argmin(cfin)) if not cfin.all() else len(crow)
            if cpre > 1 and np.any(np.diff(crow[:cpre]) < -1e-9):
                k = int(np.flatnonzero(np.diff(crow[:cpre]) < -1e-9)[0])
                out.append(_v("FLT_SURFACE_NONMONOTONE", Severity.ERROR, art,
                              f"cost_matrix[{d}, {k}:{k + 2}]",
                              f"cost surface for {name!r} decreases "
                              f"(${crow[k]:g}/h -> ${crow[k + 1]:g}/h) "
                              "within its feasible prefix"))
        elif prefix > 1 and np.any(np.diff(row[:prefix]) < 0):
            k = int(np.flatnonzero(np.diff(row[:prefix]) < 0)[0])
            out.append(_v("FLT_SURFACE_NONMONOTONE", Severity.ERROR, art,
                          f"slots_matrix[{d}, {k}:{k + 2}]",
                          f"slot surface for {name!r} decreases "
                          f"({int(row[k])} -> {int(row[k + 1])}) within its "
                          "feasible prefix"))
        if deep and models is not None and grid_ok and spot_ok:
            alg = allocator or (e.schedule.allocator if e.schedule else None)
            if alg is not None and prefix > 0:
                out.extend(_spot_check_surface(
                    e, row, plan.grid, prefix, _models_for(models, name),
                    alg, art, d, speed=spot_speed, mem_per_slot=spot_mem))
    total = plan.total_estimated_slots
    if plan.budget_slots is not None and total > plan.budget_slots:
        out.append(_v("FLT_BUDGET_EXCEEDED", Severity.ERROR, art,
                      "entries",
                      f"estimated slots {total} exceed the budget "
                      f"{plan.budget_slots}"))
    budget_dollars = getattr(plan, "budget_dollars", None)
    if (cost_matrix is not None and budget_dollars is not None
            and dollars_total > budget_dollars * (1 + REL_TOL)):
        out.append(_v("FLT_BUDGET_DOLLARS_EXCEEDED", Severity.ERROR, art,
                      "entries",
                      f"estimated fleet cost ${dollars_total:g}/h exceeds "
                      f"the budget ${budget_dollars:g}/h"))
    if sorted(vm.id for vm in plan.pool) != sorted(pool_want):
        out.append(_v("FLT_POOL_MISMATCH", Severity.ERROR, art, "pool",
                      f"pool VM ids {sorted(vm.id for vm in plan.pool)} != "
                      f"union of entry VMs {sorted(pool_want)}"))
    return out


def _spot_check_surface(entry, row: np.ndarray, grid: np.ndarray,
                        prefix: int, models: ModelLibrary, allocator: str,
                        art: str, d: int, *, speed: float = 1.0,
                        mem_per_slot: float = 1.0) -> List[Violation]:
    """Recompute up to three cells of a cached surface row with a fresh
    ``batch_slots`` pass — catches a stale/corrupted ``SlotSurfaceCache``
    without paying a full grid pass.  ``speed``/``mem_per_slot`` replay the
    VM class the row was computed for."""
    from ..core.batch import batch_slots
    ks = sorted({0, max(0, min(entry.grid_index, prefix - 1)), prefix - 1})
    fresh = batch_slots(entry.dag, grid[ks], models, allocator,
                        clip_unsupportable=True, speed=speed,
                        mem_per_slot=mem_per_slot)
    out: List[Violation] = []
    for k, got in zip(ks, fresh):
        if int(row[k]) != int(got):
            out.append(_v("FLT_SURFACE_STALE", Severity.ERROR, art,
                          f"slots_matrix[{d}, {k}]",
                          f"cached slot estimate {int(row[k])} != fresh "
                          f"batch_slots {int(got)} at rate {grid[k]:g}"))
    return out


def verify_rate_decisions(grid: np.ndarray, decisions: Mapping,
                          budget_slots: int) -> List[Violation]:
    """Cheap coherence of an incremental replan's :class:`RateDecision` set
    (the ``replan_incremental`` validate hook): grid sanity, every decision
    on the grid, total estimate within budget."""
    art = "RateDecisions"
    out: List[Violation] = list(verify_grid(grid, art))
    grid_ok = not out
    total = 0
    for name, dec in decisions.items():
        path = f"decisions[{name!r}]"
        if dec.grid_index >= 0:
            total += dec.estimated_slots
            if grid_ok and (dec.grid_index >= len(grid) or
                            not _close(dec.omega,
                                       float(grid[dec.grid_index]))):
                out.append(_v("FLT_GRID_MISMATCH", Severity.ERROR, art, path,
                              f"omega={dec.omega:g} is not "
                              f"grid[{dec.grid_index}]"))
        elif dec.omega != 0.0 or dec.estimated_slots != 0:
            out.append(_v("FLT_GRID_MISMATCH", Severity.ERROR, art, path,
                          "grid_index=-1 requires omega=0/slots=0"))
    if total > budget_slots:
        out.append(_v("FLT_BUDGET_EXCEEDED", Severity.ERROR, art,
                      "decisions",
                      f"estimated slots {total} exceed the budget "
                      f"{budget_slots}"))
    return out


# ---------------------------------------------------------------------------
# Event traces (online layer).
# ---------------------------------------------------------------------------

def verify_trace(trace, live: Iterable[str] = ()) -> List[Violation]:
    """Well-formedness of an :class:`EventTrace`: nondecreasing finite
    times, no duplicate arrivals, no events against DAGs that are not live
    (use-after-depart), positive event payloads.  ``live`` seeds the DAG
    names already in the fleet before the trace starts."""
    from ..core.online import (DagArrive, DagDepart, ModelRefresh,
                                RateChange, VmAdd, VmFail)
    art = "EventTrace"
    out: List[Violation] = []
    alive = set(live)
    prev_t = None
    for i, (t, ev) in enumerate(trace):
        path = f"events[{i}]"
        if not np.isfinite(t) or t < 0:
            out.append(_v("TRC_BAD_TIME", Severity.ERROR, art, path,
                          f"event time {t!r} must be finite and >= 0"))
        elif prev_t is not None and t < prev_t:
            out.append(_v("TRC_UNORDERED", Severity.ERROR, art, path,
                          f"time {t:g} goes backwards (previous {prev_t:g})"))
        prev_t = t if prev_t is None else max(prev_t, t)
        if isinstance(ev, DagArrive):
            if ev.name in alive:
                out.append(_v("TRC_DUP_ARRIVE", Severity.ERROR, art, path,
                              f"DAG {ev.name!r} arrives while already live"))
            alive.add(ev.name)
            if ev.weight <= 0:
                out.append(_v("TRC_BAD_EVENT", Severity.ERROR, art, path,
                              f"arrival weight {ev.weight!r} must be > 0"))
        elif isinstance(ev, (DagDepart, RateChange)):
            if ev.name not in alive:
                out.append(_v("TRC_UNKNOWN_DAG", Severity.ERROR, art, path,
                              f"{type(ev).__name__} for DAG {ev.name!r} "
                              "which is not live (use-after-depart?)"))
            if isinstance(ev, DagDepart):
                alive.discard(ev.name)
            elif ev.max_rate is not None and ev.max_rate < 0:
                out.append(_v("TRC_BAD_EVENT", Severity.ERROR, art, path,
                              f"rate ceiling {ev.max_rate!r} must be >= 0"))
        elif isinstance(ev, VmAdd):
            if ev.slots <= 0:
                out.append(_v("TRC_BAD_EVENT", Severity.ERROR, art, path,
                              f"VmAdd.slots {ev.slots!r} must be > 0"))
        elif isinstance(ev, VmFail):
            if ev.vm_id < 0:
                out.append(_v("TRC_BAD_EVENT", Severity.ERROR, art, path,
                              f"VmFail.vm_id {ev.vm_id!r} must be >= 0"))
        elif isinstance(ev, ModelRefresh):
            if not all(isinstance(k, str) for k in ev.kinds):
                out.append(_v("TRC_BAD_EVENT", Severity.ERROR, art, path,
                              f"ModelRefresh.kinds {ev.kinds!r} must name "
                              "task kinds (strings)"))
        else:
            out.append(_v("TRC_BAD_EVENT", Severity.ERROR, art, path,
                          f"unknown event type {type(ev).__name__}"))
    return out


# ---------------------------------------------------------------------------
# Controller state (online layer).
# ---------------------------------------------------------------------------

def verify_controller(ctl, *, deep: bool = False,
                      changed: Optional[Sequence[str]] = None
                      ) -> List[Violation]:
    """State coherence of a live :class:`FleetController` (the per-event
    ``validate=`` hook): entries↔dags↔cache key agreement, fleet-unique VM
    ids below the id counter, log↔entry thread-count agreement, and the
    full fleet-plan pass over the materialized snapshot.

    ``changed`` (the event's rescheduled DAG names) restricts the per-entry
    schedule walks to the entries this event touched — unchanged entries
    were verified by the event that last touched them — keeping the
    per-event cost array-level.  Pass ``None`` (default) for a full sweep.
    """
    art = "FleetController"
    out: List[Violation] = []
    if set(ctl._entries) != set(ctl._dags):
        out.append(_v("CTL_ENTRY_DAG_MISMATCH", Severity.ERROR, art,
                      "_entries",
                      f"entry names {sorted(ctl._entries)} != live DAGs "
                      f"{sorted(ctl._dags)}"))
        return out                      # the snapshot below needs agreement
    if set(ctl.cache.names()) != set(ctl._dags):
        out.append(_v("CTL_CACHE_MISMATCH", Severity.ERROR, art, "cache",
                      f"cached surfaces {sorted(ctl.cache.names())} != live "
                      f"DAGs {sorted(ctl._dags)}"))
        return out                      # plan snapshot reads cache rows
    for attr in ("_weights", "_priorities", "_max_rates"):
        orphans = sorted(set(getattr(ctl, attr)) - set(ctl._dags))
        if orphans:
            out.append(_v("CTL_META_ORPHAN", Severity.ERROR, art, attr,
                          f"entries for departed/unknown DAGs {orphans}"))
    pool = ctl.pool
    behind = sorted({vm.id for vm in pool if vm.id >= ctl._next_vm_id})
    if behind:
        out.append(_v("CTL_VM_COUNTER_BEHIND", Severity.ERROR, art,
                      "_next_vm_id",
                      f"VM ids {behind} at or above the id counter "
                      f"{ctl._next_vm_id} (fresh acquisitions would "
                      "collide)"))
    if len(ctl.log.records):
        rec = ctl.log.records[-1]
        threads_now = sum(len(e.schedule.mapping.assignment)
                          for e in ctl._entries.values() if e.schedule)
        if rec.threads_total != threads_now:
            out.append(_v("CTL_LOG_THREADS", Severity.ERROR, art,
                          "log.records[-1].threads_total",
                          f"log says {rec.threads_total} mapped threads, "
                          f"entries hold {threads_now} (migration delta "
                          "does not conserve threads)"))
    out.extend(verify_fleet_plan(ctl.plan, ctl.models if deep else None,
                                 deep=deep, schedules_for=changed))
    return out

# ---------------------------------------------------------------------------
# Live enactment (runtime layer).
# ---------------------------------------------------------------------------

def verify_enactment(fleet) -> List[Violation]:
    """Live-executor ↔ controller coherence (the :class:`LiveFleet`
    ``validate=`` hook): every mapped controller entry has exactly one
    executor, each executor enacts the entry's *exact* schedule object
    (the identity rail), its slot groups cover the schedule's mapping, and
    its op cache holds one op per (task, slot) group — anything
    else is ``EXE_DELTA_DIVERGED``.

    Duck-typed on the fleet (``ctl``, ``executors``) so the analysis layer
    does not import the runtime package.
    """
    art = "LiveFleet"
    out: List[Violation] = []
    ctl = fleet.ctl
    executors = fleet.executors
    mapped = {n for n in ctl.dag_names if ctl.entry(n).schedule is not None}
    extra = sorted(set(executors) - mapped)
    missing = sorted(mapped - set(executors))
    if extra:
        out.append(_v("EXE_DELTA_DIVERGED", Severity.ERROR, art, "executors",
                      f"executors {extra} have no mapped controller entry "
                      "(retire delta not enacted)"))
    if missing:
        out.append(_v("EXE_DELTA_DIVERGED", Severity.ERROR, art, "executors",
                      f"mapped DAGs {missing} have no executor "
                      "(spawn delta not enacted)"))
    for name in sorted(mapped & set(executors)):
        ex = executors[name]
        sched = ctl.entry(name).schedule
        path = f"executors[{name!r}]"
        if ex.schedule is not sched:
            out.append(_v("EXE_DELTA_DIVERGED", Severity.ERROR, art,
                          f"{path}.schedule",
                          "executor schedule is not the controller entry's "
                          "schedule object (delta applied to a copy or "
                          "not applied)"))
            continue
        want_slots = set(sched.mapping.slots())
        have_slots = {s for g in ex.groups.values() for s in g}
        if have_slots != want_slots:
            out.append(_v("EXE_DELTA_DIVERGED", Severity.ERROR, art,
                          f"{path}.groups",
                          f"executor slot groups cover {sorted(map(repr, have_slots))} "
                          f"but the schedule maps {sorted(map(repr, want_slots))}"))
        want_ops = {(task, slot) for task, g in ex.groups.items()
                    for slot in g}
        have_ops = set(ex._ops)
        if have_ops != want_ops:
            stale = sorted(f"{t}@{s!r}" for t, s in have_ops - want_ops)
            absent = sorted(f"{t}@{s!r}" for t, s in want_ops - have_ops)
            out.append(_v("EXE_DELTA_DIVERGED", Severity.ERROR, art,
                          f"{path}._ops",
                          "op cache diverges from the slot groups"
                          + (f"; stale {stale}" if stale else "")
                          + (f"; missing {absent}" if absent else "")))
        undevised = sorted(repr(s) for s in want_slots
                           if s not in ex.slot_device)
        if undevised:
            out.append(_v("EXE_DELTA_DIVERGED", Severity.ERROR, art,
                          f"{path}.slot_device",
                          f"mapped slots {undevised} have no device pin"))
    return out


# ---------------------------------------------------------------------------
# Measured-model recalibration (calibrate layer).
# ---------------------------------------------------------------------------

def verify_calibration(before: ModelLibrary, result) -> List[Violation]:
    """Interpolation-soundness of a recalibrated library
    (:func:`repro_torch.core.calibrate.recalibrate`'s ``validate=`` hook).

    A recalibration is a uniform positive rescale of each kind's rate
    column: the thread-count grid, CPU/memory columns, ``static`` flags,
    and the *shape* of the rate profile (the sign pattern of successive
    rate differences, which the interpolated ``I`` and its integer-grid
    inverse ``T`` rely on) must survive — any break is
    ``CAL_TABLE_NONMONOTONE``.
    """
    art = "CalibrationResult"
    out: List[Violation] = []
    after = result.library
    if set(after.kinds()) != set(before.kinds()):
        out.append(_v("CAL_TABLE_NONMONOTONE", Severity.ERROR, art,
                      "library",
                      f"recalibrated kinds {sorted(after.kinds())} != "
                      f"original kinds {sorted(before.kinds())}"))
        return out
    for kind in sorted(before.kinds()):
        old, new = before[kind], after[kind]
        path = f"library[{kind!r}]"
        if new.static != old.static:
            out.append(_v("CAL_TABLE_NONMONOTONE", Severity.ERROR, art, path,
                          "recalibration flipped the static flag"))
        old_taus = [p.tau for p in old.points]
        new_taus = [p.tau for p in new.points]
        if new_taus != old_taus:
            out.append(_v("CAL_TABLE_NONMONOTONE", Severity.ERROR, art, path,
                          f"thread-count grid changed {old_taus} -> "
                          f"{new_taus} (recalibration only rescales rates)"))
            continue
        rates = np.array([p.rate for p in new.points], dtype=float)
        if not np.all(np.isfinite(rates)) or np.any(rates <= 0):
            out.append(_v("CAL_TABLE_NONMONOTONE", Severity.ERROR, art, path,
                          f"recalibrated rates {rates.tolist()} must be "
                          "positive and finite"))
            continue
        for field in ("cpu", "mem"):
            if any(getattr(n, field) != getattr(o, field)
                   for n, o in zip(new.points, old.points)):
                out.append(_v("CAL_TABLE_NONMONOTONE", Severity.ERROR, art,
                              path,
                              f"recalibration changed the {field} column "
                              "(only rates are measured)"))
        old_sign = np.sign(np.diff([p.rate for p in old.points]))
        new_sign = np.sign(np.diff(rates))
        if len(old_sign) and not np.array_equal(old_sign, new_sign):
            out.append(_v("CAL_TABLE_NONMONOTONE", Severity.ERROR, art, path,
                          "rate-profile shape changed: successive-difference "
                          f"signs {old_sign.tolist()} -> {new_sign.tolist()} "
                          "(a uniform positive rescale preserves them)"))
    return out


# ---------------------------------------------------------------------------
# Telemetry (obs layer).
# ---------------------------------------------------------------------------

def verify_tracer(tracer) -> List[Violation]:
    """Well-formedness of a :class:`repro_torch.obs.trace.Tracer` timeline.

    * ``OBS_SPAN_UNCLOSED`` — the calling thread still has open spans: an
      instrumentation site entered a span and never exited (an exception
      path that bypassed ``__exit__``, or a hand-opened span leaked).
    * ``OBS_SPAN_NEGATIVE`` — a closed span's end precedes its start,
      which under the shared clock seam means the clock was swapped
      mid-span (timestamps from two different clocks were mixed).
    """
    art = "Tracer"
    out: List[Violation] = []
    open_names = tracer.open_spans()
    if open_names:
        out.append(_v("OBS_SPAN_UNCLOSED", Severity.ERROR, art, "open",
                      f"{len(open_names)} span(s) still open on this "
                      f"thread: {open_names}"))
    for i, span in enumerate(tracer.spans):
        if span.t1 < span.t0:
            out.append(_v("OBS_SPAN_NEGATIVE", Severity.ERROR, art,
                          f"spans[{i}]",
                          f"span {span.name!r} ends before it starts "
                          f"(t0={span.t0!r}, t1={span.t1!r}) — clocks "
                          "mixed mid-span?"))
    return out


def verify_autorecal(fleet) -> List[Violation]:
    """Thrash-freedom of the closed recalibration loop
    (:class:`repro_torch.runtime.enact.LiveFleet` with an ``AutoRecalPolicy``).

    ``CAL_AUTO_RECAL_LOOP`` fires when two recorded recalibrations sit
    closer together (in controller events) than the policy's
    ``cooldown_events`` — the loop is reacting to its own corrections,
    i.e. oscillating drift is thrashing the planning tables.
    """
    art = "LiveFleet"
    out: List[Violation] = []
    policy = getattr(fleet, "auto_recal", None)
    ticks = list(getattr(fleet, "recal_ticks", ()))
    if policy is None or len(ticks) < 2:
        return out
    for i in range(1, len(ticks)):
        gap = ticks[i] - ticks[i - 1]
        if gap < policy.cooldown_events:
            out.append(_v(
                "CAL_AUTO_RECAL_LOOP", Severity.ERROR, art,
                f"recal_ticks[{i}]",
                f"recalibrations at event ticks {ticks[i - 1]} and "
                f"{ticks[i]} are {gap} events apart, inside the "
                f"{policy.cooldown_events}-event cooldown — the loop is "
                "chasing its own corrections"))
    return out
