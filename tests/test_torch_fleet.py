"""The port's fleet planner (``core/fleet.py``), its fleet co-simulation,
``plan_serving_fleet`` and the verifier passes it runs, against the
reference's, on the CPU.

Both packages plan the same fleets with their own copies of the planner:
planned rates and every ``FleetPlan`` field (surfaces, entries, VM pools,
mappings, costs, predictions) must be equal, on the fleets of
tests/test_fleet.py and tests/test_hetero.py under all four objectives and
with ``refine_search``.  ``simulate_fleet(device="cpu")`` (the sweep
kernel's plain version) must lie within 1e-10 of the reference's
``engine="numpy"`` on what tests/test_simulator_scan.py checks: per DAG the
actual max stable and predicted max rates, the verdicts and latency
series, per slot the busy share, per VM the actual CPU and memory.  The
reference's ``scan`` engine is not run: it needs
``jax.experimental.enable_x64``, which the installed JAX lacks.

Every port planner call here runs the copied verifier passes
(``validate`` on by default, as tests/conftest.py does for the
reference), so each artifact is also checked free of violations; the
corrupted ones must raise the reference's codes.
"""

import copy
import dataclasses
import itertools

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.analysis import verify as ref_verify
from repro_torch.analysis import verify as port_verify
from repro_torch.kernels.sweep_scan import kernel as sweep_kernel

STEP, MAX_RATE = 10.0, 1000.0
TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _validate_port_plans():
    prev = port.set_default_validate(True)
    yield
    port.set_default_validate(prev)


@pytest.fixture(scope="module")
def libs():
    return port.paper_library(), ref.paper_library()


def dags_of(pkg, names):
    return {n: pkg.ALL_DAGS[n.rstrip("0123456789")]() for n in names}


def bench_names(size):
    """benchmarks/bench_fleet.py's fleet of ``size`` cycled seed DAGs."""
    return [f"{n}{i}" for i, n in enumerate(
        itertools.islice(itertools.cycle(port.ALL_DAGS), size))]


# -- comparable summaries ---------------------------------------------------------

def vm_key(vm, class_names=True):
    return (vm.id, vm.num_slots, vm.rack, vm.speed,
            vm.vm_class if class_names else None, vm.cost_per_hour,
            vm.mem_per_slot)


def schedule_summary(s, class_names=True):
    if s is None:
        return None
    return {
        "omega": s.omega, "allocator": s.allocator, "mapper": s.mapper,
        "threads": {t: (a.threads, a.rate, a.cpu, a.mem)
                    for t, a in s.allocation.tasks.items()},
        "estimated": s.estimated_slots, "acquired": s.acquired_slots,
        "vms": [vm_key(vm, class_names) for vm in s.vms],
        "mapping": sorted((repr(th), sl.vm, sl.slot)
                          for th, sl in s.mapping.assignment.items()),
        "search_winner": s.search_winner}


def prediction_summary(p):
    if p is None:
        return None
    def by_slot(d):
        return sorted(((s.vm, s.slot), v) for s, v in d.items())
    return (p.omega, by_slot(p.slot_cpu), by_slot(p.slot_mem),
            sorted(p.vm_cpu.items()), sorted(p.vm_mem.items()))


def plan_summary(fp, class_names=True):
    """Every field of a FleetPlan as plain values (slots and VMs by id)."""
    arrays = {f: (None if getattr(fp, f) is None
                  else np.asarray(getattr(fp, f)).tolist())
              for f in ("grid", "slots_matrix", "cost_matrix",
                        "class_matrix")}
    return {
        "objective": fp.objective, "budget_slots": fp.budget_slots,
        "budget_dollars": fp.budget_dollars, **arrays,
        "pool": [vm_key(vm, class_names) for vm in fp.pool],
        "overflow": fp.overflow_slots, "policy": fp.policy.value,
        "classes": [(c.slots, c.speed, c.cost_per_hour, c.mem_per_slot)
                    for c in fp.vm_classes],
        "total_estimated": fp.total_estimated_slots,
        "total_acquired": fp.total_acquired_slots,
        "cost": fp.cost_per_hour, "preemption": fp.preemption_order(),
        "vm_cpu": sorted(fp.vm_cpu.items()),
        "vm_mem": sorted(fp.vm_mem.items()),
        "entries": {n: {
            "weight": e.weight, "priority": e.priority, "omega": e.omega,
            "grid_index": e.grid_index, "estimated": e.estimated_slots,
            "vm_class": e.vm_class if class_names else None,
            "est_cost": e.est_cost_per_hour,
            "schedule": schedule_summary(e.schedule, class_names),
            "prediction": prediction_summary(e.prediction),
            "indexed": e.group_index is not None}
            for n, e in fp.entries.items()}}


def assert_plans_equal(ours, theirs, class_names=True):
    a, b = plan_summary(ours, class_names), plan_summary(theirs, class_names)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


# -- fleet planning ---------------------------------------------------------------

TEST_FLEET_FLEETS = [                           # tests/test_fleet.py FLEETS
    (("linear", "diamond"), 12),
    (("linear", "diamond", "star"), 8),
    (("linear", "diamond", "star"), 17),
    (("linear", "diamond", "star", "traffic"), 14),
]


@pytest.mark.parametrize("mapper", [None, "sam"])
@pytest.mark.parametrize("names, budget", TEST_FLEET_FLEETS,
                         ids=lambda x: str(x))
def test_max_min_fleets_equal_reference(libs, names, budget, mapper):
    lib, jlib = libs
    kw = dict(budget_slots=budget, objective="max_min", mapper=mapper,
              step=STEP, max_rate=MAX_RATE)
    assert_plans_equal(port.plan_fleet(dags_of(port, names), lib, **kw),
                       ref.plan_fleet(dags_of(ref, names), jlib, **kw))


@pytest.mark.parametrize("weights, budget", [
    ({"linear": 2.0, "diamond": 1.0, "star": 1.5}, 12),
    ({"linear": 3.0, "diamond": 1.0, "star": 1.0}, 9),
    ({"linear": 1.0, "diamond": 2.5}, 14),
], ids=["3dags-12", "3dags-9", "2dags-14"])
def test_weighted_fleets_equal_reference(libs, weights, budget):
    lib, jlib = libs
    kw = dict(budget_slots=budget, objective="weighted", weights=weights,
              step=STEP, max_rate=MAX_RATE)
    assert_plans_equal(port.plan_fleet(dags_of(port, weights), lib, **kw),
                       ref.plan_fleet(dags_of(ref, weights), jlib, **kw))


@pytest.mark.parametrize("case", ["priority", "max_rates", "zero_ceiling",
                                  "per_dag_libraries", "micro_dags"])
def test_fleet_options_equal_reference(libs, case):
    lib, jlib = libs
    names = ("linear", "diamond", "star")
    kw = dict(budget_slots=12, step=STEP, max_rate=MAX_RATE)
    port_lib, ref_lib = lib, jlib
    if case == "priority":
        kw.update(objective="priority",
                  priorities={"linear": 2, "diamond": 1, "star": 0})
    elif case == "max_rates":
        kw.update(max_rates={"linear": 55.0}, budget_slots=14)
    elif case == "zero_ceiling":
        kw.update(max_rates={"linear": 0.0}, budget_slots=14)
    elif case == "per_dag_libraries":
        port_lib = {n: lib for n in names}
        ref_lib = {n: jlib for n in names}
    else:
        names = tuple(port.MICRO_DAGS)
        kw.update(budget_slots=24)
    assert_plans_equal(port.plan_fleet(dags_of(port, names), port_lib, **kw),
                       ref.plan_fleet(dags_of(ref, names), ref_lib, **kw))


@pytest.mark.parametrize("objective", ["max_min", "weighted", "priority"])
@pytest.mark.parametrize("classes", ["sizes", "unit_classes"])
def test_hetero_unit_classes_equal_reference(libs, objective, classes):
    """tests/test_hetero.py's equivalence rail: the (4, 2, 1) pool as plain
    sizes and as unit classes, every slot-budget objective."""
    lib, jlib = libs
    kw = dict(budget_slots=20, objective=objective, step=STEP,
              max_rate=MAX_RATE)
    if objective == "weighted":
        kw["weights"] = {"linear": 2.0, "diamond": 1.0, "star": 3.0}
    if objective == "priority":
        kw["priorities"] = {"linear": 1, "diamond": 0, "star": 2}
    sizes = {"port": (4, 2, 1), "ref": (4, 2, 1)}
    if classes == "unit_classes":
        sizes = {"port": port.vm_classes_from_sizes((4, 2, 1)),
                 "ref": ref.vm_classes_from_sizes((4, 2, 1))}
    names = ("linear", "diamond", "star")
    assert_plans_equal(
        port.plan_fleet(dags_of(port, names), lib, vm_sizes=sizes["port"],
                        **kw),
        ref.plan_fleet(dags_of(ref, names), jlib, vm_sizes=sizes["ref"],
                       **kw))


def _cost_classes(pkg):
    return (pkg.VmClass("big", 8, cost_per_hour=0.60),
            pkg.VmClass("small", 2, cost_per_hour=0.20))


@pytest.mark.parametrize("names, dollars", [
    (("linear", "diamond"), 1.0),
    (("linear", "diamond"), 2.2),
    (("linear", "diamond", "star"), 1.6),
    (("linear", "diamond", "star"), 2.5),
], ids=["2dags-$1", "2dags-$2.2", "3dags-$1.6", "3dags-$2.5"])
def test_min_cost_fleets_equal_reference(libs, names, dollars):
    lib, jlib = libs
    kw = dict(budget_dollars=dollars, objective="min_cost", step=STEP,
              max_rate=MAX_RATE)
    assert_plans_equal(
        port.plan_fleet(dags_of(port, names), lib,
                        vm_sizes=_cost_classes(port), **kw),
        ref.plan_fleet(dags_of(ref, names), jlib,
                       vm_sizes=_cost_classes(ref), **kw))


def test_fast_class_fleet_equals_reference(libs):
    """A speed-2 class family: surfaces computed at the classes' speed."""
    lib, jlib = libs
    fast = {pkg: (pkg.VmClass("f4", 4, speed=2.0, cost_per_hour=1.0),
                  pkg.VmClass("f1", 1, speed=2.0, cost_per_hour=0.30))
            for pkg in (port, ref)}
    kw = dict(budget_slots=10, step=STEP, max_rate=MAX_RATE)
    names = ("linear", "star")
    assert_plans_equal(
        port.plan_fleet(dags_of(port, names), lib, vm_sizes=fast[port], **kw),
        ref.plan_fleet(dags_of(ref, names), jlib, vm_sizes=fast[ref], **kw))


@pytest.mark.parametrize("size, budget", [(2, 16), (3, 32), (4, 64), (6, 64),
                                          (8, 96), (12, 128)])
def test_bench_fleet_sizes_equal_reference(libs, size, budget):
    """benchmarks/bench_fleet.py's cycled seed DAGs, and two fleets past
    its largest, planned with mba/sam."""
    lib, jlib = libs
    names = bench_names(size)
    kw = dict(budget_slots=budget, objective="max_min", mapper="sam")
    assert_plans_equal(port.plan_fleet(dags_of(port, names), lib, **kw),
                       ref.plan_fleet(dags_of(ref, names), jlib, **kw))


def test_refine_search_equals_reference(libs):
    """The opt-in refinement: each DAG's pinned-pool search on the port's
    plain version ranks as the reference's numpy-engine search does, so
    the refined plans are equal, counters included."""
    lib, jlib = libs
    names = ("linear", "diamond")
    opts = dict(n_moves=2, rate_fractions=[0.8, 1.0, 1.2], duration=4.0,
                dt=0.1)
    s_port, s_ref = {}, {}
    ours = port.plan_fleet(dags_of(port, names), lib, budget_slots=10,
                           refine_search=True, stats=s_port,
                           search_opts=dict(opts, device="cpu"))
    theirs = ref.plan_fleet(dags_of(ref, names), jlib, budget_slots=10,
                            refine_search=True, stats=s_ref,
                            search_opts=dict(opts, engine="numpy"))
    assert_plans_equal(ours, theirs)
    assert s_port == s_ref and s_port["search_candidates"] > 0


def test_surface_cache_and_incremental_replan_equal_reference(libs):
    """A warm SlotSurfaceCache skips every grid pass, and
    ``replan_incremental`` over it picks the reference's rates."""
    lib, jlib = libs
    names = ("linear", "diamond", "star")
    caches = {pkg: pkg.SlotSurfaceCache(allocator="mba", step=STEP,
                                        max_rate=MAX_RATE)
              for pkg in (port, ref)}
    for pkg, lb in ((port, lib), (ref, jlib)):
        pkg.plan_fleet(dags_of(pkg, names), lb, budget_slots=12,
                       mapper=None, surface_cache=caches[pkg], step=STEP,
                       max_rate=MAX_RATE)
    stats = {}
    port.plan_fleet(dags_of(port, names), lib, budget_slots=12, mapper=None,
                    surface_cache=caches[port], stats=stats, step=STEP,
                    max_rate=MAX_RATE)
    assert stats["batch_passes"] == 0
    for budget in (6, 12, 30):
        a = port.replan_incremental(caches[port], list(names),
                                    budget_slots=budget)
        b = ref.replan_incremental(caches[ref], list(names),
                                   budget_slots=budget)
        assert {n: (d.omega, d.grid_index, d.estimated_slots)
                for n, d in a.items()} == \
            {n: (d.omega, d.grid_index, d.estimated_slots)
             for n, d in b.items()}


def test_fleet_errors_equal_reference(libs):
    lib, _ = libs
    with pytest.raises(port.UnsupportableDagError) as err:
        port.plan_fleet(dags_of(port, ("linear", "diamond")), lib,
                        budget_slots=2, mapper=None, step=100.0,
                        max_rate=MAX_RATE)
    assert err.value.dag in ("linear", "diamond")
    assert err.value.budget_slots == 2
    for kw in (dict(budget_slots=10, objective="nope"),
               dict(budget_slots=0),
               dict(budget_slots=10, weights={"linear": -1.0}),
               dict(budget_slots=10, objective="min_cost"),
               dict(budget_dollars=1.0, objective="max_min")):
        with pytest.raises(ValueError):
            port.plan_fleet(dags_of(port, ("linear",)), lib, **kw)


def test_fleet_resource_surfaces_equal_reference(libs):
    lib, jlib = libs
    names = tuple(port.MICRO_DAGS)
    kw = dict(budget_slots=24, step=STEP, max_rate=MAX_RATE)
    ours = port.fleet_resource_surfaces(
        port.plan_fleet(dags_of(port, names), lib, **kw), lib)
    theirs = ref.fleet_resource_surfaces(
        ref.plan_fleet(dags_of(ref, names), jlib, **kw), jlib)
    assert ours.keys() == theirs.keys()
    for n in ours:
        a, b = ours[n], theirs[n]
        assert a.vm_ids == b.vm_ids
        for f in ("omegas", "slot_cpu", "slot_mem", "vm_cpu", "vm_mem"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (n, f)


def test_plan_serving_fleet_equals_reference():
    """The serving wrapper under the reference's roofline constants picks
    the reference's request rates, GPU (chip) counts and hosts under every
    slot-budget objective."""
    from repro.configs import get_config as ref_config
    from repro.serve import ServingWorkload as RefWorkload
    from repro.serve import plan_serving_fleet as ref_plan_serving_fleet
    from repro_torch.configs import get_config
    from repro_torch.serve import ServingWorkload, plan_serving_fleet
    from test_torch_planner import REF_HW

    def workloads(make, cfg):
        return [make("chat", cfg, prompt_len=2048, gen_len=256, weight=2.0,
                     priority=1),
                make("code", cfg, prompt_len=4096, gen_len=512)]

    ours = workloads(ServingWorkload, get_config("minicpm-2b"))
    theirs = workloads(RefWorkload, ref_config("minicpm-2b"))
    for objective in ("max_min", "weighted", "priority"):
        a = plan_serving_fleet(ours, budget_hosts=16, objective=objective,
                               hardware=REF_HW)
        b = ref_plan_serving_fleet(theirs, budget_hosts=16,
                                   objective=objective)
        assert_plans_equal(a, b, class_names=False)
        assert a.total_estimated_slots <= 16
    with pytest.raises(ValueError):
        plan_serving_fleet([ours[0], ours[0]], budget_hosts=16)


# -- co-simulation ------------------------------------------------------------------

def assert_reports_close(ours, theirs):
    """What tests/test_simulator_scan.py asks of a fleet co-simulation, and
    the report's other fields."""
    assert ours.entries.keys() == theirs.entries.keys()
    assert ours.skipped == theirs.skipped
    assert ours.at_fraction == theirs.at_fraction
    assert np.array_equal(ours.fractions, theirs.fractions)
    for name, a in ours.entries.items():
        b = theirs.entries[name]
        assert a.omega_planned == b.omega_planned
        assert np.array_equal(a.omegas, b.omegas)
        assert a.actual_max_stable == b.actual_max_stable, name
        assert a.predicted_max_rate == b.predicted_max_rate, name
        assert a.proved == b.proved and a.planned_is_stable == \
            b.planned_is_stable
        assert len(a.results) == len(b.results)
        for ra, rb in zip(a.results, b.results):
            assert ra.omega == rb.omega and ra.stable == rb.stable
            assert ra.latency_slope == pytest.approx(rb.latency_slope,
                                                     abs=TOL)
            np.testing.assert_allclose(ra.latency_samples, rb.latency_samples,
                                       rtol=TOL, atol=TOL)
            assert ra.queue_total == pytest.approx(rb.queue_total, rel=TOL,
                                                   abs=TOL)
    busy_a = {(s.vm, s.slot): v for s, v in ours.slot_busy.items()}
    busy_b = {(s.vm, s.slot): v for s, v in theirs.slot_busy.items()}
    assert busy_a.keys() == busy_b.keys()
    for slot, v in busy_b.items():
        assert busy_a[slot] == pytest.approx(v, rel=TOL, abs=TOL)
    for f in ("vm_cpu_actual", "vm_mem_actual"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.keys() == b.keys()
        for vm, v in b.items():
            assert a[vm] == pytest.approx(v, rel=TOL, abs=TOL), (f, vm)
    for f in ("vm_cpu_predicted", "vm_mem_predicted"):
        assert getattr(ours, f) == getattr(theirs, f), f


COSIM_FLEETS = {
    "linear+diamond": (("linear", "diamond"), 12),
    "micro": (tuple(port.MICRO_DAGS), 24),
    "bench4": (bench_names(4), 64),
    "bench6": (bench_names(6), 64),
    "bench8": (bench_names(8), 96),
    "bench12": (bench_names(12), 128),
}


@pytest.mark.parametrize("policy", ["shuffle", "slot_aware"])
@pytest.mark.parametrize("fleet", list(COSIM_FLEETS))
def test_simulate_fleet_equals_reference_numpy(libs, fleet, policy):
    """One co-simulated sweep of the whole fleet through the plain version
    within 1e-10 of the reference's numpy engine."""
    lib, jlib = libs
    names, budget = COSIM_FLEETS[fleet]
    kw = dict(budget_slots=budget)
    fp = port.plan_fleet(dags_of(port, names), lib, **kw)
    jfp = ref.plan_fleet(dags_of(ref, names), jlib, **kw)
    sim_kw = dict(duration=8.0, dt=0.1,
                  policy=port.RoutingPolicy(policy))
    ours = port.simulate_fleet(fp, lib, device="cpu", **sim_kw)
    sim_kw["policy"] = ref.RoutingPolicy(policy)
    theirs = ref.simulate_fleet(jfp, jlib, engine="numpy", **sim_kw)
    assert ours.engine == "scan"
    assert_reports_close(ours, theirs)
    assert ours.describe()


def test_simulate_fleet_engines_and_devices(libs, monkeypatch):
    """The port's numpy engine gives its plain version's report; the
    default device is CUDA, which raises without a card, and nothing
    falls back to the CPU; an unmapped plan is refused."""
    lib, _ = libs
    fp = port.plan_fleet(dags_of(port, ("linear", "star")), lib,
                         budget_slots=12)
    kw = dict(duration=4.0, dt=0.1)
    assert_reports_close(port.simulate_fleet(fp, lib, device="cpu", **kw),
                         port.simulate_fleet(fp, lib, engine="numpy", **kw))
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    before = sweep_kernel.launch_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        port.simulate_fleet(fp, lib, **kw)
    assert sweep_kernel.launch_count() == before
    unmapped = port.plan_fleet(dags_of(port, ("linear",)), lib,
                               budget_slots=12, mapper=None)
    with pytest.raises(ValueError):
        port.simulate_fleet(unmapped, lib, device="cpu")


# -- the verifier --------------------------------------------------------------

def _codes(violations):
    return sorted((v.code, v.severity.name) for v in violations)


def _corrupt_fleet(fp, how):
    fp = copy.deepcopy(fp)
    first, second = list(fp.entries.values())[:2]
    if how == "vm_dup":
        second.schedule.vms[0] = dataclasses.replace(
            second.schedule.vms[0], id=first.schedule.vms[0].id)
    elif how == "grid":
        first.omega += 1.0
    elif how == "slots":
        first.estimated_slots += 1
    elif how == "pool":
        fp.pool = fp.pool[:-1]
    elif how == "budget":
        fp.budget_slots = 1
    elif how == "thread_dropped":
        assignment = first.schedule.mapping.assignment
        del assignment[next(iter(assignment))]
    elif how == "surface":
        fp.slots_matrix = fp.slots_matrix.copy()
        fp.slots_matrix[0, 3] = fp.slots_matrix[0, 2] - 1
    return fp


@pytest.mark.parametrize("how", ["clean", "vm_dup", "grid", "slots", "pool",
                                 "budget", "thread_dropped", "surface"])
def test_verify_fleet_plan_codes_equal_reference(libs, how):
    lib, jlib = libs
    names = ("linear", "diamond", "star")
    kw = dict(budget_slots=14, step=STEP, max_rate=MAX_RATE)
    fp = port.plan_fleet(dags_of(port, names), lib, **kw)
    jfp = ref.plan_fleet(dags_of(ref, names), jlib, **kw)
    ours = port_verify.verify_fleet_plan(_corrupt_fleet(fp, how), lib,
                                         deep=True)
    theirs = ref_verify.verify_fleet_plan(_corrupt_fleet(jfp, how), jlib,
                                          deep=True)
    assert _codes(ours) == _codes(theirs)
    assert bool(ours) == (how != "clean")


@pytest.mark.parametrize("how", ["clean", "thread_dropped", "slot_outside",
                                 "threads_changed", "dag_edge"])
def test_plan_verifier_codes_equal_reference(libs, how):
    """``plan(validate=True)``'s passes (dag, allocation, schedule) on a
    clean plan and on corrupted copies: the reference's codes, and the
    port's ``plan`` raises PlanIntegrityError where they are errors."""
    lib, jlib = libs
    s = port.plan(port.traffic_dag(), 80.0, lib, validate=True)
    js = ref.plan(ref.traffic_dag(), 80.0, jlib, validate=True)

    def corrupt(sched, pkg):
        sched = copy.deepcopy(sched)
        assignment = sched.mapping.assignment
        thread = next(iter(assignment))
        if how == "thread_dropped":
            del assignment[thread]
        elif how == "slot_outside":
            assignment[thread] = pkg.SlotId(10 ** 6, 0)
        elif how == "threads_changed":
            task = next(iter(sched.allocation.tasks.values()))
            task.threads += 1
        elif how == "dag_edge":
            sched.dag.edges[0] = dataclasses.replace(sched.dag.edges[0],
                                                     selectivity=-1.0)
        return sched

    def passes(verify, sched, models):
        return (verify.verify_dag(sched.dag)
                + verify.verify_allocation(sched.allocation, sched.dag,
                                           models)
                + verify.verify_schedule(sched))

    ours = passes(port_verify, corrupt(s, port), lib)
    theirs = passes(ref_verify, corrupt(js, ref), jlib)
    assert _codes(ours) == _codes(theirs)
    assert bool(ours) == (how != "clean")


def test_plan_validate_runs_the_copied_passes(libs, monkeypatch):
    """``plan(validate=...)`` and ``plan_fleet(validate=...)`` call the
    port's own verifier passes, and raise on what they find."""
    lib, _ = libs
    seen = []
    for name in ("verify_dag", "verify_allocation", "verify_schedule",
                 "verify_fleet_plan"):
        real = getattr(port_verify, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(port_verify, name, spy)
    port.plan(port.linear_dag(), 50.0, lib, validate=True)
    assert seen == ["verify_dag", "verify_allocation", "verify_schedule"]
    seen.clear()
    port.plan(port.linear_dag(), 50.0, lib, validate=False)
    assert seen == []
    port.plan_fleet(dags_of(port, ("linear", "star")), lib, budget_slots=12,
                    validate=True)
    assert "verify_fleet_plan" in seen
    monkeypatch.setattr(port_verify, "verify_schedule", lambda *a, **k: [
        port.Violation("SCH_THREAD_MISSING", port.Severity.ERROR, "s", "p",
                       "injected")])
    with pytest.raises(port.PlanIntegrityError):
        port.plan(port.linear_dag(), 50.0, lib, validate=True)
