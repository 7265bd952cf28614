"""The port's online fleet controller (``core/online.py``), failure replans,
the static rate-stability prover (``analysis/prove.py``) and the
controller's verifier passes, against the reference's, on the CPU.

Both packages replay the same event scripts (the traces of
tests/test_online.py and tests/test_hetero.py, and
benchmarks/bench_online.py's 20-event day) through their own controllers:
after every event the record (rates, what changed, threads migrated,
slots moved, grid passes, $/hour) and the whole materialized ``FleetPlan``
must be equal.  Co-simulating replays run the port on ``device="cpu"``
(the sweep kernel's plain version) against the reference's
``engine="numpy"``, with ``cosimulate(prove=True)`` and without; their
stability verdicts must be equal.  The prover's verdicts, margins and
codes must equal the reference's on tests/test_prove.py's cells.
"""

import copy
import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.analysis import prove as ref_prove
from repro.analysis import verify as ref_verify
from repro.core import scheduler as ref_scheduler
from repro_torch.analysis import prove as port_prove
from repro_torch.analysis import verify as port_verify
from repro_torch.core import scheduler as port_scheduler
from test_torch_fleet import assert_plans_equal, schedule_summary

STEP, MAX_RATE = 10.0, 1000.0


@pytest.fixture(scope="module", autouse=True)
def _validate_port_plans():
    prev = port.set_default_validate(True)
    yield
    port.set_default_validate(prev)


@pytest.fixture(scope="module")
def libs():
    return port.paper_library(), ref.paper_library()


# -- scripted traces ---------------------------------------------------------------

def event(pkg, ctl, kind, payload):
    """One scripted event for ``pkg``'s controller ``ctl``.  A ``fail``
    payload names a VM by id or as (DAG, index into its schedule's VMs);
    a callable payload is evaluated on the controller first."""
    if callable(payload):
        payload = payload(ctl)
    if kind == "arrive":
        name, dag, kw = payload
        return pkg.DagArrive(name, pkg.ALL_DAGS[dag](), **kw)
    if kind == "depart":
        return pkg.DagDepart(payload)
    if kind == "rate":
        return pkg.RateChange(*payload)
    if kind == "grow":
        return pkg.VmAdd(payload)
    if kind == "fail":
        if not isinstance(payload, int):
            name, which = payload
            payload = ctl.entry(name).schedule.vms[which].id
        return pkg.VmFail(payload)
    raise ValueError(kind)


def record_summary(r):
    return (r.time, r.kind, r.rates, r.changed, r.threads_migrated,
            r.threads_total, r.slots_moved, r.batch_passes, r.stable,
            r.fleet_cost_per_hour, r.drift_alerts, r.recalibrated)


def assert_controllers_equal(ctl, jctl):
    assert ctl.dag_names == jctl.dag_names
    assert ctl.budget_slots == jctl.budget_slots
    assert [record_summary(r) for r in ctl.log.records] == \
        [record_summary(r) for r in jctl.log.records]
    if ctl.dag_names:
        assert_plans_equal(ctl.plan, jctl.plan)


ARRIVE3 = [("arrive", ("linear", "linear", dict(weight=1.0, priority=1))),
           ("arrive", ("diamond", "diamond", dict(weight=1.5))),
           ("rate", ("linear", 50.0)),
           ("arrive", ("star", "star", dict(weight=2.0))),
           ("grow", 6),
           ("rate", ("linear", None)),
           ("depart", "diamond")]

SCRIPTS = {
    # tests/test_online.py
    "events_max_min": (dict(objective="max_min", mapper=None), ARRIVE3),
    "events_weighted": (dict(objective="weighted", mapper=None), ARRIVE3),
    "events_priority": (dict(objective="priority", mapper=None), ARRIVE3),
    "events_sam": (dict(objective="max_min", mapper="sam"), ARRIVE3),
    "untouched": (dict(objective="priority", mapper="sam"), [
        ("arrive", ("linear", "linear", dict(priority=1))),
        ("arrive", ("star", "star", dict(priority=0))),
        ("rate", lambda c: ("linear", c.entry("linear").omega))]),
    "vmfail": (dict(mapper="sam"), [
        ("arrive", ("linear", "linear", {})),
        ("arrive", ("diamond", "diamond", {})),
        ("fail", ("diamond", 0)),
        ("fail", 10_000)]),
    "vmfail_fleet_ids": (dict(mapper="sam", budget_slots=30), [
        ("arrive", ("linear", "linear", dict(max_rate=50.0))),
        ("arrive", ("diamond", "diamond", {})),
        ("fail", lambda c: max(vm.id for vm in c.entry("linear").schedule
                               .vms))]),
    "growth": (dict(mapper="sam", budget_slots=12), [
        ("arrive", ("linear", "linear", {})),
        ("arrive", ("diamond", "diamond", {})),
        ("grow", 10)]),
    # tests/test_hetero.py
    "unit_classes": (dict(budget_slots=18, vm_sizes="unit_classes"), [
        ("arrive", ("linear", "linear", dict(max_rate=150.0))),
        ("arrive", ("star", "star", {})),
        ("rate", ("linear", 60.0)),
        ("depart", "star")]),
    "self_size": (dict(self_size=True, budget_slots=None, vm_sizes=(4, 2, 1)),
                  [("arrive", ("linear", "linear", dict(max_rate=200.0))),
                   ("arrive", ("star", "star", dict(max_rate=150.0))),
                   ("rate", ("linear", 60.0)),
                   ("depart", "star")]),
    "speed_class": (dict(budget_slots=40, vm_sizes="fast"), [
        ("arrive", ("linear", "linear", dict(max_rate=200.0))),
        ("arrive", ("traffic", "traffic", dict(max_rate=80.0))),
        ("fail", ("traffic", -1))]),
}


def controller(pkg, lib, **kw):
    kw = dict(dict(budget_slots=16, step=STEP, max_rate=MAX_RATE), **kw)
    if kw.get("vm_sizes") == "unit_classes":
        kw["vm_sizes"] = pkg.vm_classes_from_sizes((4, 2, 1))
    elif kw.get("vm_sizes") == "fast":
        kw["vm_sizes"] = (pkg.VmClass("f4", 4, speed=2.0, cost_per_hour=1.0),
                          pkg.VmClass("f1", 1, speed=2.0,
                                      cost_per_hour=0.30))
    return pkg.FleetController(lib, **kw)


def drive(libs, opts, script):
    """Both controllers through the script, compared after every event."""
    (lib, jlib) = libs
    ctl, jctl = controller(port, lib, **opts), controller(ref, jlib, **opts)
    for t, (kind, payload) in enumerate(script):
        rec = ctl.apply(event(port, ctl, kind, payload), at=float(t))
        jrec = jctl.apply(event(ref, jctl, kind, payload), at=float(t))
        assert record_summary(rec) == record_summary(jrec), (t, kind)
        assert_controllers_equal(ctl, jctl)
    return ctl, jctl


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_controller_traces_equal_reference(libs, script):
    drive(libs, *SCRIPTS[script])


def test_recalibration_equals_reference(libs):
    """``recalibrate`` with tables whose 'parse_xml' rates were measured 20%
    low: every surface and schedule is rebuilt the same way."""
    def slower(pkg, lib):
        out = pkg.paper_library()
        m = lib["parse_xml"]
        out.add(pkg.PerfModel.from_points("parse_xml", {
            p.tau: (0.8 * p.rate, p.cpu, p.mem) for p in m.points}))
        return out

    ctl, jctl = drive(libs, dict(mapper="sam", budget_slots=24),
                      SCRIPTS["vmfail"][1][:2])
    lib, jlib = libs
    rec = ctl.recalibrate(slower(port, lib), at=9.0, kinds=("parse_xml",))
    jrec = jctl.recalibrate(slower(ref, jlib), at=9.0, kinds=("parse_xml",))
    assert rec.recalibrated and record_summary(rec) == record_summary(jrec)
    assert_controllers_equal(ctl, jctl)


def test_controller_errors_equal_reference(libs):
    """Refused events raise the reference's errors and leave no trace."""
    lib, jlib = libs
    for pkg, lb in ((port, lib), (ref, jlib)):
        ctl = controller(pkg, lb, budget_slots=2, step=100.0)
        with pytest.raises(pkg.UnsupportableDagError) as err:
            ctl.apply(pkg.DagArrive("linear", pkg.linear_dag()))
        assert err.value.dag == "linear"
        assert ctl.dag_names == [] and len(ctl.log) == 0
        with pytest.raises(ValueError):
            ctl.apply(pkg.VmAdd(0))
        ctl.apply(pkg.VmAdd(30))
        ctl.apply(pkg.DagArrive("linear", pkg.linear_dag()))
        with pytest.raises(ValueError):
            ctl.apply(pkg.DagArrive("linear", pkg.linear_dag()))
        for bad in (pkg.DagDepart("nope"), pkg.RateChange("nope", 10.0)):
            with pytest.raises(ValueError):
                ctl.apply(bad)
    with pytest.raises(ValueError):
        port.FleetController(lib, budget_slots=10, self_size=True)


# -- co-simulating replays ---------------------------------------------------------

#: benchmarks/bench_online.py's trace: a bursty day that grows to eight DAGs
BENCH_TRACE = [
    ("arrive", ("lin-a", "linear", dict(max_rate=100.0))),
    ("arrive", ("dia-a", "diamond", dict(max_rate=150.0))),
    ("arrive", ("star-a", "star", dict(max_rate=80.0))),
    ("rate", ("lin-a", 150.0)),
    ("arrive", ("tra-a", "traffic", dict(max_rate=120.0))),
    ("grow", 6),
    ("arrive", ("lin-b", "linear", dict(max_rate=60.0))),
    ("fail", ("lin-a", -1)),
    ("rate", ("star-a", 700.0)),
    ("rate", ("star-a", 720.0)),
    ("grow", 8),
    ("rate", ("star-a", 80.0)),
    ("arrive", ("star-b", "star", dict(max_rate=70.0))),
    ("rate", ("lin-a", 151.0)),
    ("arrive", ("dia-b", "diamond", dict(max_rate=100.0))),
    ("fail", ("tra-a", -1)),
    ("rate", ("tra-a", 60.0)),
    ("arrive", ("tra-b", "traffic", dict(max_rate=90.0))),
    ("depart", "lin-b"),
    ("grow", 4),
]
BENCH_OPTS = dict(budget_slots=44, mapper="sam", step=2.0, max_rate=2000.0)


def timed_trace(pkg, lib, script, opts):
    """The script as an EventTrace at t = 0, 1, ...: VM failures are
    resolved to ids by a dry run (planning is deterministic, so a fresh
    controller meets the same ids)."""
    dry = controller(pkg, lib, **opts)
    events = []
    for t, (kind, payload) in enumerate(script):
        ev = event(pkg, dry, kind, payload)
        dry.apply(ev)
        events.append((float(t), ev))
    return pkg.EventTrace(events)


REPLAYS = {
    "test_online": (dict(mapper="sam"), [
        ("arrive", ("linear", "linear", {})),
        ("arrive", ("diamond", "diamond", {})),
        ("rate", ("linear", 50.0))],
        dict(fractions=[0.5, 1.0], duration=3.0, dt=0.1, warmup=1.0)),
    "bench_online": (BENCH_OPTS, BENCH_TRACE,
                     dict(duration=4.0, dt=0.1, warmup=1.0)),
}


@pytest.mark.parametrize("prove", [False, True])
@pytest.mark.parametrize("replay", list(REPLAYS))
def test_replay_with_cosimulation_equals_reference(libs, replay, prove):
    """``replay(simulate=True)``: every record's co-simulated stability
    verdicts, on the plain version, equal the reference's numpy engine;
    with ``prove=True`` the prover decides what it can first."""
    lib, jlib = libs
    opts, script, sim_kw = REPLAYS[replay]
    ctl, jctl = controller(port, lib, **opts), controller(ref, jlib, **opts)
    log = ctl.replay(timed_trace(port, lib, script, opts), simulate=True,
                     device="cpu", prove=prove, **sim_kw)
    jlog = jctl.replay(timed_trace(ref, jlib, script, opts), simulate=True,
                       engine="numpy", prove=prove, **sim_kw)
    assert len(log) == len(script)
    assert all(r.stable for r in log.records)
    assert_controllers_equal(ctl, jctl)
    assert len(jlog) == len(log) and "ControllerLog" in log.describe()


@pytest.fixture(scope="module")
def prove_ctl(libs):
    """tests/test_prove.py's smoke fleet on each package's controller."""
    lib, jlib = libs
    out = []
    for pkg, lb in ((port, lib), (ref, jlib)):
        ctl = pkg.FleetController(lb, budget_slots=12, mapper="sam",
                                  step=STEP, max_rate=300.0, validate=False)
        for name in ("linear", "diamond", "star"):
            ctl.apply(pkg.DagArrive(name, pkg.ALL_DAGS[name]()))
        out.append(ctl)
    return tuple(out)


@pytest.mark.parametrize("fractions", [None, [0.5, 1.0, 3.0]])
def test_cosimulate_equals_reference(prove_ctl, fractions):
    """``cosimulate`` without and with ``prove``: the same entries, verdicts
    and rates; the proved path simulates nothing where every cell is
    decided."""
    ctl, jctl = prove_ctl
    for prove in (False, True):
        ours = ctl.cosimulate(fractions=fractions, duration=8.0, dt=0.1,
                              prove=prove, device="cpu")
        theirs = jctl.cosimulate(fractions=fractions, duration=8.0, dt=0.1,
                                 prove=prove, engine="numpy")
        assert ours.engine == ("scan" if theirs.engine == "numpy"
                               else theirs.engine)
        assert ours.entries.keys() == theirs.entries.keys()
        for name, a in ours.entries.items():
            b = theirs.entries[name]
            assert (a.proved, a.planned_is_stable, a.actual_max_stable,
                    a.predicted_max_rate) == \
                (b.proved, b.planned_is_stable, b.actual_max_stable,
                 b.predicted_max_rate), (prove, name)
            assert [r.stable for r in a.results] == \
                [r.stable for r in b.results]


# -- failure replans -----------------------------------------------------------------

@pytest.mark.parametrize("mapper", ["sam", "rsm", "dsm"])
@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("dag", ["diamond", "traffic"])
def test_replan_on_failure_equals_reference(libs, dag, mapper, keep):
    lib, jlib = libs
    s = port.plan(port.ALL_DAGS[dag](), 120.0, lib, mapper=mapper,
                  vm_sizes=(4, 2, 1))
    js = ref.plan(ref.ALL_DAGS[dag](), 120.0, jlib, mapper=mapper,
                  vm_sizes=(4, 2, 1))
    failed = [s.vms[0].id, s.vms[-1].id]
    a = port_scheduler.replan_on_failure(s, lib, failed, keep_survivors=keep,
                                         next_vm_id=40)
    b = ref_scheduler.replan_on_failure(js, jlib, failed, keep_survivors=keep,
                                        next_vm_id=40)
    assert schedule_summary(a) == schedule_summary(b)
    assert not {vm.id for vm in a.vms} & set(failed)


# -- the prover ----------------------------------------------------------------------

def _proof(p):
    return (p.name, p.omega, p.verdict, p.proved, p.margin, p.binding,
            sorted((v.code, v.severity.name, v.path) for v in p.violations))


@pytest.fixture(scope="module")
def cells(libs):
    """tests/test_prove.py's linear plan at 40 t/s, slot-aware, per
    package: (schedule, group index, library)."""
    out = {}
    for pkg, lb in zip((port, ref), libs):
        s = pkg.plan(pkg.linear_dag(), 40.0, lb)
        gi = pkg.build_group_index(s.dag, s.allocation, s.mapping, lb,
                                   pkg.RoutingPolicy.SLOT_AWARE)
        out[pkg] = (s, gi, lb)
    return out


@pytest.mark.parametrize("case", ["planned", "overdriven", "borderline",
                                  "zero_capacity", "cpu_oversub",
                                  "half_rate", "slack"])
def test_prove_group_index_equals_reference(cells, case):
    def run(pkg, mod):
        s, gi, _ = cells[pkg]
        kw, omega = {}, s.omega
        if case == "overdriven":
            omega *= 10.0
        elif case == "borderline":
            kw["selectivity_slack"] = 0.9
        elif case == "zero_capacity":
            gi = copy.deepcopy(gi)
            gi.g_cap[:] = 0.0
        elif case == "cpu_oversub":
            gi = copy.deepcopy(gi)
            gi.g_cpu[:] = 5.0
        elif case == "half_rate":
            omega *= 0.5
        elif case == "slack":
            kw.update(rate_slack=0.05, selectivity_slack=0.05)
        return _proof(mod.prove_group_index(gi, omega, **kw))

    ours, theirs = run(port, port_prove), run(ref, ref_prove)
    assert ours == theirs
    want = {"planned": port_prove.PROVED_STABLE,
            "overdriven": port_prove.PROVED_UNSTABLE,
            "borderline": port_prove.UNPROVABLE,
            "zero_capacity": port_prove.PROVED_UNSTABLE,
            "cpu_oversub": port_prove.UNPROVABLE}
    if case in want:
        assert ours[2] == want[case]


@pytest.mark.parametrize("case", ["clean", "rate305", "overdriven301"])
def test_prove_allocation_equals_reference(cells, case):
    def run(pkg, mod):
        s, _, lb = cells[pkg]
        alloc = copy.deepcopy(s.allocation)
        if case == "rate305":
            alloc.tasks[next(iter(alloc.tasks))].rate *= 3.0
        elif case == "overdriven301":
            alloc.omega *= 50.0
            for ta in alloc.tasks.values():
                ta.rate *= 50.0
        return _proof(mod.prove_allocation(s.dag, alloc, lb))

    assert run(port, port_prove) == run(ref, ref_prove)


def test_beta_intervals_equal_reference(cells):
    for slack in (0.0, 0.1):
        a = port_prove.beta_intervals(cells[port][1], selectivity_slack=slack)
        b = ref_prove.beta_intervals(cells[ref][1], selectivity_slack=slack)
        assert [(i.lo, i.hi) for i in a] == [(i.lo, i.hi) for i in b]


def test_prove_fleet_equals_reference(prove_ctl):
    ctl, jctl = prove_ctl
    fracs = np.linspace(0.25, 1.25, 9)
    ours = port_prove.prove_fleet(ctl.plan, ctl.models, fractions=fracs)
    theirs = ref_prove.prove_fleet(jctl.plan, jctl.models, fractions=fracs)
    assert ours.keys() == theirs.keys() and ours
    for name in ours:
        assert [_proof(p) for p in ours[name]] == \
            [_proof(p) for p in theirs[name]]
    unmapped = copy.deepcopy(ctl.plan)
    unmapped.entries["linear"].schedule = None
    assert "linear" not in port_prove.prove_fleet(unmapped, ctl.models)


# -- the controller's verifier passes ---------------------------------------------------

def _codes(violations):
    return sorted((v.code, v.severity.name, v.path) for v in violations)


def _trace(pkg):
    return pkg.EventTrace([
        (0.0, pkg.DagArrive("linear", pkg.linear_dag())),
        (1.0, pkg.DagArrive("linear", pkg.linear_dag(), weight=-1.0)),
        (2.0, pkg.RateChange("star", 10.0)),
        (3.0, pkg.DagDepart("linear")),
        (4.0, pkg.RateChange("linear", -5.0)),
        (5.0, pkg.VmAdd(0)),
        (6.0, pkg.VmFail(-1)),
        (7.0, pkg.ModelRefresh(kinds=(3,))),
    ])


def test_verify_trace_codes_equal_reference():
    ours = port_verify.verify_trace(_trace(port), live=("star",))
    theirs = ref_verify.verify_trace(_trace(ref), live=("star",))
    assert _codes(ours) == _codes(theirs) and ours
    unordered = [(2.0, port.VmAdd(1)), (1.0, port.VmAdd(1))]
    trace = port.EventTrace(unordered)
    trace.events = unordered
    junordered = [(2.0, ref.VmAdd(1)), (1.0, ref.VmAdd(1))]
    jtrace = ref.EventTrace(junordered)
    jtrace.events = junordered
    assert _codes(port_verify.verify_trace(trace)) == \
        _codes(ref_verify.verify_trace(jtrace)) != []


@pytest.mark.parametrize("how", ["clean", "entry_missing", "cache_missing",
                                 "orphan_weight", "counter_behind",
                                 "log_threads"])
def test_verify_controller_codes_equal_reference(prove_ctl, how):
    def corrupt(ctl):
        ctl = copy.deepcopy(ctl)
        if how == "entry_missing":
            del ctl._entries["star"]
        elif how == "cache_missing":
            ctl.cache.drop("star")
        elif how == "orphan_weight":
            ctl._weights["ghost"] = 1.0
        elif how == "counter_behind":
            ctl._next_vm_id = 0
        elif how == "log_threads":
            ctl.log.records[-1] = dataclasses.replace(
                ctl.log.records[-1],
                threads_total=ctl.log.records[-1].threads_total + 1)
        return ctl

    ctl, jctl = prove_ctl
    ours = port_verify.verify_controller(corrupt(ctl), deep=True)
    theirs = ref_verify.verify_controller(corrupt(jctl), deep=True)
    assert _codes(ours) == _codes(theirs)
    assert bool(ours) == (how != "clean")
