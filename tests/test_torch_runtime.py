"""The port's streaming runtime (``runtime/{stream,chaos,executor,enact}.py``)
and its measure→recalibrate loop (``core/calibrate.py``) against the
reference's, on the CPU.

Both packages run the same seeded streams, fault plans and event traces
under a :class:`VirtualClock`, where operator time is priced from the
model tables, so everything is deterministic: the port's frames, fault
timelines, execution reports, rebind deltas, enactment records and
calibration results must equal the reference's exactly.  The port runs
its executors on ``device="cpu"`` (the operator kernels' plain versions).
The reference's ``LiveFleet.drift`` co-simulates on its ``scan`` engine,
which cannot run on the installed JAX (``jax.experimental.enable_x64`` is
gone), so its controller's ``cosimulate`` is bound to ``engine="numpy"``
inside these tests; the scan engine is specified to match numpy.  The
port's drift co-simulates on its own ``scan`` engine on the CPU (the sweep
kernel's plain version).  Device frame counts are compared by slot,
through each executor's slot-to-device map: the reference names its CPU
device ``TFRT_CPU_0``, the port ``cpu``.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; the GPU machine has none

import repro.core as ref_core
import repro.runtime as ref_rt
import repro_torch.core as port_core
import repro_torch.runtime as port_rt
from benchmarks import bench_chaos

PKGS = {"port": (port_core, port_rt), "ref": (ref_core, ref_rt)}
BUDGET = 24
REPORT_FIELDS = ("omega", "frames", "tuples", "wall_seconds", "throughput",
                 "mean_latency", "p99_latency", "latency_slope", "stable",
                 "stable_reason", "frames_shed", "frames_timed_out",
                 "frames_failed", "retries", "tuples_lost", "escalated_vms")


@pytest.fixture(scope="module", autouse=True)
def _validate_port_plans():
    prev = port_core.set_default_validate(True)
    yield
    port_core.set_default_validate(prev)


@pytest.fixture(scope="module")
def libs():
    return {"port": port_core.paper_library(), "ref": ref_core.paper_library()}


# -- builders, one per package -------------------------------------------------

def fleet(which, lib, **kw):
    """A LiveFleet of ``which`` package on a VirtualClock; the port's on the
    CPU, the reference's drift co-simulating on numpy."""
    core, rt = PKGS[which]
    budget = kw.pop("budget_slots", BUDGET)
    ctl = core.FleetController(lib, budget_slots=budget)
    kw.setdefault("clock", rt.VirtualClock())
    if which == "port":
        return rt.LiveFleet(ctl, device="cpu", **kw)
    ctl.cosimulate = functools.partial(ctl.cosimulate, engine="numpy")
    return rt.LiveFleet(ctl, **kw)


def executor(which, schedule, lib, **kw):
    _, rt = PKGS[which]
    kw.setdefault("clock", rt.VirtualClock())
    if which == "port":
        kw["device"] = "cpu"
    return rt.StreamExecutor(schedule, lib, **kw)


def plan_of(which, lib, dag, omega):
    core, _ = PKGS[which]
    return core.plan(core.ALL_DAGS[dag](), omega, lib, allocator="mba",
                     mapper="sam")


def fault(which, kind, **kw):
    _, rt = PKGS[which]
    return rt.Fault(rt.FaultKind[kind], **kw)


def fault_plan(which, faults=(), seed=None):
    _, rt = PKGS[which]
    return rt.FaultPlan(faults=tuple(faults), seed=seed)


def bursty(which, seed=7):
    _, rt = PKGS[which]
    return rt.FaultPlan.from_seed(seed, dags=["d1", "d2"], tasks=["b", "c"],
                                  horizon_frames=20, operator_errors=2,
                                  slowdowns=2, drops=1)


def chaos_plan(which):
    """bench_chaos._fault_plan(): seed 11 plus the correlated 2-VM crash."""
    _, rt = PKGS[which]
    fpe = bench_chaos.FRAMES_PER_EVENT
    seeded = rt.FaultPlan.from_seed(
        11, dags=["lin-a", "dia-a", "dia-b"], tasks=["b", "c"],
        horizon_frames=fpe * 10, operator_errors=3, slowdowns=3, drops=2)
    crash = fpe * 7 + 4
    return rt.FaultPlan(faults=seeded.faults + tuple(
        rt.Fault(rt.FaultKind.VM_CRASH, frame=crash, dag="lin-a", vm_index=i)
        for i in (0, 1)), seed=seeded.seed)


def chaos_events(which, trace=bench_chaos.TRACE):
    core, _ = PKGS[which]
    for kind, payload in trace:
        if kind == "arrive":
            name, maker, demand = payload
            yield core.DagArrive(name, core.ALL_DAGS[maker](), max_rate=demand)
        elif kind == "rate":
            yield core.RateChange(*payload)
        else:
            yield core.DagDepart(payload)


def small_trace(which):
    core, _ = PKGS[which]
    return core.EventTrace([
        (0.0, core.DagArrive("d1", core.diamond_dag(), max_rate=80.0)),
        (1.0, core.DagArrive("d2", core.diamond_dag(), max_rate=60.0)),
        (2.0, core.RateChange("d1", 50.0)),
    ])


def scaled(which, lib, factor, scale_static=True):
    """Every rate of ``lib`` times ``factor`` (bench_chaos._doubled; with
    ``scale_static`` off, tests/test_obs.py's _scaled)."""
    core, _ = PKGS[which]
    out = core.ModelLibrary()
    for kind in lib.kinds():
        m = lib[kind]
        f = factor if (scale_static or not m.static) else 1.0
        out.add(core.PerfModel(kind, [core.ModelPoint(p.tau, p.rate * f,
                                                      p.cpu, p.mem)
                                      for p in m.points], static=m.static))
    return out


# -- summaries compared across packages -----------------------------------------

def slot_key(s):
    return (s.vm, s.slot)


def report_summary(rep):
    return tuple(getattr(rep, f) for f in REPORT_FIELDS) + (
        sorted(rep.device_frame_counts.values()),)


def counts_by_slot(ex, rep):
    """Frame counts keyed by the slots pinned to each device."""
    out = {}
    for name, n in rep.device_frame_counts.items():
        slots = tuple(sorted(slot_key(s) for s, d in ex.slot_device.items()
                             if str(d) == name))
        out[slots] = n
    return out


def rebind_summary(info):
    return ([slot_key(s) for s in info.kept_slots],
            [slot_key(s) for s in info.restarted_slots],
            sorted((slot_key(a), slot_key(b))
                   for a, b in info.transplanted.items()),
            info.reused_ops, info.fresh_ops)


def controller_summary(r):
    return (r.time, r.kind, r.rates, r.changed, r.threads_migrated,
            r.threads_total, r.slots_moved, r.batch_passes, r.stable,
            r.fleet_cost_per_hour, r.drift_alerts, r.recalibrated)


def record_summary(rec):
    return dict(
        time=rec.time, controller=controller_summary(rec.controller),
        spawned=rec.spawned, retired=rec.retired, untouched=rec.untouched,
        rebound={n: rebind_summary(i) for n, i in rec.rebound.items()},
        reports={n: report_summary(r) for n, r in rec.reports.items()},
        escalations=rec.escalations,
        repairs=[controller_summary(r) for r in rec.repairs],
        recovery={n: report_summary(r)
                  for n, r in rec.recovery_reports.items()},
        drift_magnitude=rec.drift_magnitude, drift_alerts=rec.drift_alerts,
        recalibration=(None if rec.recalibration is None
                       else controller_summary(rec.recalibration)),
        rates=rec.rates)


def assert_logs_equal(port_log, ref_log):
    assert len(port_log) == len(ref_log)
    assert port_log.rates_sequence() == ref_log.rates_sequence()
    assert port_log.timeline.signature() == ref_log.timeline.signature()
    for a, b in zip(port_log.records, ref_log.records):
        assert record_summary(a) == record_summary(b)


def measurement_summary(ms):
    return [(m.kind, m.task, m.tau, m.tuples, m.busy_seconds) for m in ms]


# -- streams and fault plans ------------------------------------------------------

@pytest.mark.parametrize("rate, batch, seed", [(100.0, 16, 0), (80.0, 32, 3),
                                               (1000.0, 7, 11)])
def test_synthetic_source_frames_bit_equal(rate, batch, seed):
    frames = {}
    for which, (_, rt) in PKGS.items():
        kw = dict(device="cpu") if which == "port" else {}
        src = rt.SyntheticSource(rate, batch=batch, seed=seed,
                                 clock=rt.VirtualClock(), start_seq=5, **kw)
        frames[which] = list(src.frames(n_frames=6))
    for p, r in zip(frames["port"], frames["ref"]):
        assert p.seq == r.seq and p.size == r.size == batch
        assert p.created == r.created
        assert p.arrays["payload"].dtype == torch.uint8
        assert p.arrays["value"].dtype == torch.float32
        for k in ("payload", "value"):
            np.testing.assert_array_equal(p.arrays[k].numpy(),
                                          np.asarray(r.arrays[k]))


@pytest.mark.parametrize("seed", (7, 8, 11))
def test_fault_plan_from_seed_equal(seed):
    port, ref = bursty("port", seed), bursty("ref", seed)
    assert port.seed == ref.seed
    assert ([(f.kind.value, f.frame, f.dag, f.task, f.vm_index, f.frames,
              f.count, f.factor, f.seconds) for f in port.faults]
            == [(f.kind.value, f.frame, f.dag, f.task, f.vm_index, f.frames,
                 f.count, f.factor, f.seconds) for f in ref.faults])
    assert port == bursty("port", seed) and port != bursty("port", seed + 1)


# -- the executor --------------------------------------------------------------------

EXECUTOR_CASES = {
    "clean": (dict(), 8),
    "bursty": (dict(faults="bursty"), 20),
    "breaker": (dict(faults=[("VM_CRASH", dict(frame=2, dag="d",
                                                vm_index=0))]), 10),
    "retry": (dict(faults=[("OPERATOR_ERROR", dict(frame=3, dag="d",
                                                    task="b", count=2))]), 8),
    "drop": (dict(faults=[("DROP_FRAME", dict(frame=2, dag="d",
                                              frames=2))]), 8),
    "slot_aware": (dict(policy="SLOT_AWARE"), 8),
}


@pytest.mark.parametrize("dag", ("diamond", "linear", "star"))
@pytest.mark.parametrize("case", sorted(EXECUTOR_CASES))
def test_executor_run_matches_reference(libs, dag, case):
    spec, n_frames = EXECUTOR_CASES[case]
    got = {}
    for which in PKGS:
        core, rt = PKGS[which]
        sched = plan_of(which, libs[which], dag, 80.0)
        kw = {}
        if spec.get("faults") == "bursty":
            plan_f = rt.FaultPlan.from_seed(7, dags=["d"], tasks=["b", "x"],
                                            horizon_frames=n_frames,
                                            operator_errors=2, slowdowns=2,
                                            drops=1)
        elif "faults" in spec:
            plan_f = fault_plan(which, [fault(which, k, **f)
                                        for k, f in spec["faults"]])
        else:
            plan_f = None
        if plan_f is not None:
            kw["faults"] = rt.FaultInjector(plan_f, "d")
        if "policy" in spec:
            kw["policy"] = core.RoutingPolicy[spec["policy"]]
        ex = executor(which, sched, libs[which],
                      robustness=rt.RobustnessPolicy(breaker_threshold=3),
                      **kw)
        reps = [ex.run(80.0, n_frames=n_frames, batch=16, seed=s)
                for s in (0, 1)]
        got[which] = (reps, ex)
    (port_reps, port_ex), (ref_reps, ref_ex) = got["port"], got["ref"]
    for p, r in zip(port_reps, ref_reps):
        assert report_summary(p) == report_summary(r)
        assert counts_by_slot(port_ex, p) == counts_by_slot(ref_ex, r)
    assert measurement_summary(port_ex.measurements()) == \
        measurement_summary(ref_ex.measurements())
    assert port_ex.tripped_vms == ref_ex.tripped_vms
    assert port_ex.frames_seen == ref_ex.frames_seen
    if "faults" in spec:
        assert port_ex.faults.timeline.signature() == \
            ref_ex.faults.timeline.signature()
    assert all(d == torch.device("cpu") for d in port_ex.slot_device.values())
    assert sum(port_ex.invocations.values()) > 0


def test_executor_counts_invocations_by_kind(libs):
    sched = plan_of("port", libs["port"], "diamond", 80.0)
    ex = executor("port", sched, libs["port"])
    ex.run(80.0, n_frames=4, batch=16)
    kinds = {sched.allocation.tasks[t].kind for t in ex.groups}
    assert set(ex.invocations) == kinds
    # every frame reaches every task; a task's frame splits over its slots
    for task, g in ex.groups.items():
        kind = sched.allocation.tasks[task].kind
        assert ex.invocations[kind] >= 4


def test_degenerate_window_reports_reason(libs):
    sched = plan_of("port", libs["port"], "diamond", 80.0)
    rep = executor("port", sched, libs["port"]).run(80, n_frames=1, batch=16,
                                                    warmup_frames=2)
    assert rep.frames == 1
    assert rep.stable is False
    assert "no post-warmup latency samples" in rep.stable_reason
    assert rep.p99_latency == 0.0 and rep.latency_slope == 0.0


def test_circuit_breaker_threshold(libs):
    sched = plan_of("port", libs["port"], "diamond", 80.0)
    plan_f = fault_plan("port", [fault("port", "VM_CRASH", frame=2, dag="d",
                                       vm_index=0)])
    ex = executor("port", sched, libs["port"],
                  faults=port_rt.FaultInjector(plan_f, "d"),
                  robustness=port_rt.RobustnessPolicy(breaker_threshold=3))
    rep = ex.run(80, n_frames=10, batch=16)
    assert rep.escalated_vms == (sched.vms[0].id,)
    assert sched.vms[0].id in ex.tripped_vms
    assert ex.take_escalations() == [sched.vms[0].id]
    assert ex.take_escalations() == []


def test_retry_absorbs_transient_operator_errors(libs):
    plan_f = fault_plan("port", [fault("port", "OPERATOR_ERROR", frame=3,
                                       dag="d1", task="b", count=2)])
    f = fleet("port", libs["port"], fault_plan=plan_f, frames_per_event=8)
    rec = f.apply(port_core.DagArrive("d1", port_core.diamond_dag(),
                                      max_rate=80.0), at=0.0)
    rep = rec.reports["d1"]
    assert rep.retries >= 2
    assert rep.frames_failed == 0 and rep.tuples_lost == 0
    assert not rec.escalations


def test_dropped_frames_are_shed_not_fatal(libs):
    plan_f = fault_plan("port", [fault("port", "DROP_FRAME", frame=2,
                                       dag="d1", frames=2)])
    f = fleet("port", libs["port"], fault_plan=plan_f, frames_per_event=8)
    rec = f.apply(port_core.DagArrive("d1", port_core.diamond_dag(),
                                      max_rate=80.0), at=0.0)
    rep = rec.reports["d1"]
    assert rep.frames_shed == 2 and rep.frames == 8
    assert rep.stable


def test_stalled_attempt_trips_the_watchdog(libs):
    """A stall longer than the frame deadline abandons the frame."""
    got = {}
    for which in PKGS:
        _, rt = PKGS[which]
        sched = plan_of(which, libs[which], "diamond", 80.0)
        plan_f = fault_plan(which, [fault(which, "SLOT_STALL", frame=3,
                                          dag="d", task="x", seconds=10.0)])
        ex = executor(which, sched, libs[which],
                      faults=rt.FaultInjector(plan_f, "d"))
        got[which] = ex.run(80, n_frames=8, batch=16)
    assert got["port"].frames_timed_out == 1
    assert report_summary(got["port"]) == report_summary(got["ref"])


def test_rebind_and_transplant_match_reference(libs):
    """tests/test_chaos.py's correlated 2-VM crash: both VMs escalate, the
    repair transplants only failed-VM slots, with zero fresh ops; every
    rebind delta equals the reference's."""
    logs = {}
    for which in PKGS:
        core, _ = PKGS[which]
        plan_f = fault_plan(which, [
            fault(which, "VM_CRASH", frame=8, dag="d1", vm_index=i)
            for i in (0, 1)])
        f = fleet(which, libs[which], fault_plan=plan_f, frames_per_event=16)
        rec = f.apply(core.DagArrive("d1", core.diamond_dag(),
                                     max_rate=200.0), at=0.0)
        logs[which] = (f, rec)
    (pf, prec), (rf, rrec) = logs["port"], logs["ref"]
    assert record_summary(prec) == record_summary(rrec)
    info = prec.rebound["d1"]
    assert info.fresh_ops == 0 and info.transplanted
    assert len(prec.escalations) == 2 == len(prec.repairs)
    ex = pf.executors["d1"]
    assert {(t, slot_key(s)) for t, s in ex._ops} == \
        {(t, slot_key(s)) for t, s in rf.executors["d1"]._ops}
    from repro_torch.analysis import verify_enactment
    assert verify_enactment(pf) == []


def test_transplant_map_matches_reference(libs):
    got = {}
    for which in PKGS:
        core, rt = PKGS[which]
        sched = plan_of(which, libs[which], "diamond", 80.0)
        failed = core.replan_on_failure(sched, libs[which],
                                        [sched.vms[0].id],
                                        keep_survivors=True)
        got[which] = (rt.transplant_map(sched, sched),
                      sorted((slot_key(a), slot_key(b)) for a, b in
                             rt.transplant_map(sched, failed).items()))
    assert got["port"] == got["ref"]
    assert got["port"][0] == {} and got["port"][1]


def test_rebind_reuses_ops_on_equal_devices(libs):
    """Pins compare by equality: a rebind onto the same schedule keeps
    every op, and a transplant onto a slot that inherited the failed
    slot's (equal, not identical) device reuses the op."""
    sched = plan_of("port", libs["port"], "diamond", 80.0)
    ex = executor("port", sched, libs["port"])
    ops = dict(ex._ops)
    info = ex.rebind(sched)
    assert info.fresh_ops == 0 and info.reused_ops == len(ops)
    assert all(ex._ops[k] is op for k, op in ops.items())
    failed = port_core.replan_on_failure(sched, libs["port"],
                                         [sched.vms[0].id],
                                         keep_survivors=True)
    moves = port_rt.transplant_map(sched, failed)
    ex.slot_device = {s: torch.device(str(d))     # fresh, equal objects
                      for s, d in ex.slot_device.items()}
    info = ex.rebind(failed, transplants=moves)
    assert info.fresh_ops == 0
    assert info.transplanted == moves


# -- the live fleet -------------------------------------------------------------------

def test_chaos_day_matches_reference(libs):
    """bench_chaos's 20-event day (4 tenants on 40 slots, 12 frames an
    event, batch 16) under its seeded FaultPlan plus the correlated crash
    of two VMs: every record equal.  As in the benchmark, the fleet's own
    enactment check is off (see the next test)."""
    logs = {}
    for which in PKGS:
        f = fleet(which, libs[which], budget_slots=bench_chaos.BUDGET,
                  fault_plan=chaos_plan(which),
                  frames_per_event=bench_chaos.FRAMES_PER_EVENT,
                  batch=bench_chaos.BATCH, validate=False)
        for i, ev in enumerate(chaos_events(which)):
            f.apply(ev, at=float(i))
        logs[which] = f
    port, ref = logs["port"], logs["ref"]
    assert_logs_equal(port.log, ref.log)
    assert len(port.log.timeline) == 15
    esc = [e for r in port.log.records for e in r.escalations]
    assert len(esc) == 2
    assert measurement_summary(port.measurements()) == \
        measurement_summary(ref.measurements())
    assert "escalate" in port.log.describe()


def test_enactment_check_flags_idle_slots_as_the_reference(libs):
    """A reference fault the port keeps: ``verify_enactment`` compares the
    executor's slot groups with ``mapping.slots()``, which lists the idle
    slots of a schedule's VMs too, so a schedule with an idle slot (the
    chaos day's first arrival, lin-a at 100 t/s on 40 slots) raises
    EXE_DELTA_DIVERGED under ``validate=True`` in both packages."""
    errors = {}
    for which in PKGS:
        core, rt = PKGS[which]
        f = fleet(which, libs[which], budget_slots=bench_chaos.BUDGET,
                  fault_plan=rt.FaultPlan.none(), validate=True)
        with pytest.raises(core.PlanIntegrityError) as err:
            f.apply(next(chaos_events(which)), at=0.0)
        errors[which] = [(v.code, v.path, v.detail)
                         for v in err.value.violations]
    assert errors["port"] == errors["ref"]
    assert [code for code, _, _ in errors["port"]] == ["EXE_DELTA_DIVERGED"]


def test_small_replay_with_bursty_faults_matches_reference(libs):
    logs = {}
    for which in PKGS:
        f = fleet(which, libs[which], fault_plan=bursty(which))
        logs[which] = f.replay(small_trace(which))
    assert len(logs["port"].timeline) > 0
    assert_logs_equal(logs["port"], logs["ref"])


def test_fault_free_round_trip_matches_headless_replay(libs):
    headless = port_core.FleetController(libs["port"], budget_slots=BUDGET
                                         ).replay(small_trace("port"))
    f = fleet("port", libs["port"], fault_plan=port_rt.FaultPlan.none())
    live = f.replay(small_trace("port"))
    assert live.rates_sequence() == [dict(r.rates) for r in headless.records]
    assert len(live.timeline) == 0
    for name in f.ctl.dag_names:
        assert f.executors[name].schedule is f.ctl.entry(name).schedule


def test_recalibration_on_exact_profiles_is_bit_identical(libs):
    f = fleet("port", libs["port"], fault_plan=port_rt.FaultPlan.none())
    f.replay(small_trace("port"))
    result = f.recalibrate()
    assert result.changed_kinds == []
    for kind in libs["port"].kinds():
        assert result.library[kind] is libs["port"][kind]
    assert result.error_before < 1e-9


def test_recalibration_halves_the_2x_error_as_the_reference(libs):
    """bench_chaos's recalibration rail: the controller plans on tables 2x
    the truth; one recalibrate pass over the first 8 events' measurements
    takes the error from 0.50 to 0.0909, equal to the reference."""
    got = {}
    for which in PKGS:
        core, rt = PKGS[which]
        wrong = scaled(which, libs[which], 2.0)
        f = fleet(which, wrong, budget_slots=bench_chaos.BUDGET,
                  fault_plan=rt.FaultPlan.none(), truth=libs[which],
                  frames_per_event=bench_chaos.FRAMES_PER_EVENT,
                  batch=bench_chaos.BATCH)
        for i, ev in enumerate(chaos_events(which, bench_chaos.TRACE[:8])):
            f.apply(ev, at=float(i))
        ms = f.measurements()
        res = core.recalibrate(wrong, ms, alpha=0.9)
        got[which] = (measurement_summary(ms), core.rate_error(wrong, ms),
                      res.error_before, res.error_after,
                      sorted(res.changed_kinds),
                      {k: (c.samples, c.ratio, c.factor, c.changed)
                       for k, c in res.per_kind.items()})
    assert got["port"] == got["ref"]
    _, before, _, after, kinds, _ = got["port"]
    assert before == pytest.approx(0.5, abs=1e-12)
    assert round(after, 4) == 0.0909
    assert len(got["port"][0]) == 47 and len(kinds) == 7


def test_auto_recalibration_rail_matches_reference(libs):
    """tests/test_obs.py's mis-profiled fleet (diamond at 4000 t/s, tables
    2x the truth but the static kinds): the damped drift crosses 0.15,
    drift confirms it through a co-simulation, and the recalibration at
    tick 0 takes the error from 0.357 to 0.065, equal to the reference."""
    got = {}
    for which in PKGS:
        core, rt = PKGS[which]
        policy = core.AutoRecalPolicy(threshold=0.15, cooldown_events=2)
        f = fleet(which, scaled(which, libs[which], 2.0, scale_static=False),
                  fault_plan=rt.FaultPlan.none(), truth=libs[which],
                  auto_recal=policy)
        rec = f.apply(core.DagArrive("d1", core.diamond_dag(),
                                     max_rate=4000.0), at=0.0)
        after = core.rate_error(f.ctl.models, f.measurements())
        got[which] = (record_summary(rec), f.recal_ticks,
                      f.recalibrations[0].error_before,
                      f.recalibrations[0].error_after, after,
                      sorted(f.recalibrations[0].changed_kinds))
    assert got["port"] == got["ref"]
    summary, ticks, before, rec_after, _, _ = got["port"]
    assert ticks == [0]
    assert summary["drift_alerts"] >= 1 and summary["recalibration"]
    assert round(before, 3) == 0.357 and round(rec_after, 3) == 0.065


def test_recalibration_respects_cooldown_as_the_reference(libs):
    got = {}
    for which in PKGS:
        core, rt = PKGS[which]
        f = fleet(which, scaled(which, libs[which], 2.0, scale_static=False),
                  fault_plan=rt.FaultPlan.none(), truth=libs[which],
                  auto_recal=core.AutoRecalPolicy(threshold=0.15,
                                                  cooldown_events=2))
        for i, ev in enumerate([
                core.DagArrive("d1", core.diamond_dag(), max_rate=4000.0),
                core.RateChange("d1", 1500.0),
                core.RateChange("d1", 1200.0)]):
            f.apply(ev, at=float(i))
        got[which] = ([record_summary(r) for r in f.log.records],
                      f.recal_ticks)
    assert got["port"] == got["ref"]
    ticks = got["port"][1]
    assert ticks and all(b - a >= 2 for a, b in zip(ticks, ticks[1:]))


def test_drift_co_simulates_on_the_fleet_device(libs, monkeypatch):
    f = fleet("port", libs["port"], fault_plan=port_rt.FaultPlan.none())
    f.apply(port_core.DagArrive("d1", port_core.diamond_dag(),
                                max_rate=80.0), at=0.0)
    seen = []
    real = f.ctl.cosimulate

    def spy(**kw):
        seen.append(kw)
        return real(**kw)
    monkeypatch.setattr(f.ctl, "cosimulate", spy)
    assert f.drift() == []
    assert seen == [{"device": torch.device("cpu")}]


def test_fleet_executors_run_on_the_fleet_device(libs):
    f = fleet("port", libs["port"], fault_plan=port_rt.FaultPlan.none())
    f.apply(port_core.DagArrive("d1", port_core.diamond_dag(),
                                max_rate=80.0), at=0.0)
    ex = f.executors["d1"]
    assert ex.device == torch.device("cpu")
    assert {op.device for op in ex._ops.values()} == {torch.device("cpu")}
    assert set(f.log.records[0].reports["d1"].device_frame_counts) == {"cpu"}
