"""The obs parts and verifier passes that came with the port's runtime,
against the reference's, on the CPU: the scoreboard
(``obs/scoreboard.py``), the span export helpers (``obs/export.py``), the
CLI (``python -m repro_torch.obs``), the profiler's trial runners
(``core/profiler.py``), and the passes ``verify_models``,
``verify_enactment``, ``verify_calibration``, ``verify_tracer`` and
``verify_autorecal``.

Each verifier runs in both packages on the reference tests' clean inputs
and on the same mutations of them (tests/test_analysis.py,
tests/test_obs.py); codes, paths and details must be equal.  Port plans
are verified throughout (``set_default_validate(True)``, as
tests/conftest.py does for the reference).  Co-simulations run the port's
scan engine on ``device="cpu"`` (the sweep kernel's plain version) and
the reference's numpy engine.
"""

import copy
import dataclasses
import json
import math
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")   # the reference; the GPU machine has none

import repro.analysis as ref_analysis
import repro.core as ref_core
import repro.obs as ref_obs
import repro.runtime as ref_rt
import repro_torch.analysis as port_analysis
import repro_torch.core as port_core
import repro_torch.obs as port_obs
import repro_torch.runtime as port_rt
from repro.core import profiler as ref_profiler
from repro_torch.core import profiler as port_profiler
from repro_torch.obs import Scoreboard
from repro_torch.obs.clock import use_clock
from repro_torch.obs.scoreboard import MEASURED, PLANNED, SIMULATED
from repro_torch.obs.trace import spans_from_jsonl, spans_to_chrome

PKGS = {"port": (port_core, port_rt, port_obs, port_analysis),
        "ref": (ref_core, ref_rt, ref_obs, ref_analysis)}
BUDGET = 24


@pytest.fixture(scope="module", autouse=True)
def _validate_port_plans():
    prev = port_core.set_default_validate(True)
    yield
    port_core.set_default_validate(prev)


@pytest.fixture(scope="module")
def libs():
    return {"port": port_core.paper_library(), "ref": ref_core.paper_library()}


@pytest.fixture
def fresh_obs():
    """A fresh enabled port tracer and a reset, enabled registry; restored
    after."""
    prev = port_obs.set_tracer(port_obs.Tracer(enabled=True))
    port_obs.REGISTRY.reset()
    port_obs.REGISTRY.enable()
    yield port_obs.get_tracer()
    port_obs.REGISTRY.disable()
    port_obs.REGISTRY.reset()
    port_obs.set_tracer(prev)


def violations(vs):
    """Comparable violations; the reference's "jitted-op cache" is the
    port's "op cache"."""
    return [(v.code, v.severity.value, v.artifact, v.path,
             v.detail.replace("jitted-op cache", "op cache")) for v in vs]


def both(fn):
    """fn(which, core, rt, obs, analysis) for both packages."""
    return {which: fn(which, *mods) for which, mods in PKGS.items()}


# -- scoreboard ----------------------------------------------------------------

def test_scoreboard_residual_math_hand_pinned():
    b = Scoreboard()
    b.record("d", "rate", PLANNED, 100.0, t=0.0)
    b.record("d", "rate", SIMULATED, 90.0, t=1.0)
    b.record("d", "rate", PLANNED, 120.0, t=2.0)   # newer promise
    b.record("d", "rate", SIMULATED, 126.0, t=3.0)
    res = b.residuals("rate", SIMULATED, "d")
    assert [r.residual for r in res] == [-10.0, 6.0]
    assert res[0].relative == pytest.approx(-0.1)
    assert res[1].relative == pytest.approx(0.05)
    stats = b.summary("rate", SIMULATED)["d"]
    assert stats.n == 2
    assert stats.mean_abs == pytest.approx(8.0)
    assert stats.rmse == pytest.approx(math.sqrt((100.0 + 36.0) / 2.0))
    assert stats.max_abs == 10.0
    assert stats.mean_abs_relative == pytest.approx(0.075)
    assert not stats.exact
    assert b.planned_sustained() == {"d": True}


def test_scoreboard_zero_promise_and_orphan_observation():
    b = Scoreboard()
    b.record("d", "rate", PLANNED, 0.0, t=0.0)
    b.record("d", "rate", MEASURED, 5.0, t=1.0)
    (r,) = b.residuals("rate", MEASURED, "d")
    assert math.isnan(r.relative)
    assert b.summary("rate", MEASURED)["d"].mean_abs_relative == 0.0
    orphan = Scoreboard()
    orphan.record("d", "rate", SIMULATED, 50.0, t=0.0)
    assert orphan.residuals("rate", SIMULATED) == []


def _board_summary(board, kind):
    return {n: (s.n, s.mean_abs, s.rmse, s.max_abs, s.mean_abs_relative,
                s.exact) for n, s in board.summary("rate", kind).items()}


def test_fault_free_rail_residuals_exactly_zero(libs):
    """Planned rates against the controller's co-simulation: every residual
    exactly 0, in both packages."""
    def run(which, core, rt, obs, analysis):
        ctl = core.FleetController(libs[which], budget_slots=BUDGET)
        ctl.apply(core.DagArrive("d1", core.diamond_dag(), max_rate=80.0))
        ctl.apply(core.DagArrive("d2", core.linear_dag(), max_rate=60.0))
        b = obs.Scoreboard()
        assert b.ingest_controller(ctl, t=0.0) == 2
        cosim = (ctl.cosimulate(device="cpu") if which == "port"
                 else ctl.cosimulate(engine="numpy"))
        assert b.ingest_cosim(cosim, t=1.0) == 2
        return _board_summary(b, SIMULATED), b.planned_sustained()
    got = both(run)
    assert got["port"] == got["ref"]
    stats, sustained = got["port"]
    assert set(stats) == {"d1", "d2"}
    assert all(s[-1] and s[3] == 0.0 for s in stats.values())
    assert sustained == {"d1": True, "d2": True}


def test_scoreboard_ingests_measured_windows(libs):
    """Measured throughputs of a live fleet's windows against its promises
    (the scoreboard's measured side), equal in both packages."""
    def run(which, core, rt, obs, analysis):
        kw = dict(device="cpu") if which == "port" else {}
        fleet = rt.LiveFleet(core.FleetController(libs[which],
                                                  budget_slots=BUDGET),
                             fault_plan=rt.FaultPlan.none(),
                             clock=rt.VirtualClock(), **kw)
        rec = fleet.apply(core.DagArrive("d1", core.diamond_dag(),
                                         max_rate=80.0), at=0.0)
        b = obs.Scoreboard()
        b.ingest_controller(fleet.ctl, t=0.0)
        n = b.ingest_reports(rec.reports, t=1.0)
        return n, _board_summary(b, MEASURED)
    got = both(run)
    assert got["port"] == got["ref"] and got["port"][0] == 1


# -- export and CLI ----------------------------------------------------------------

def test_jsonl_round_trip(fresh_obs):
    with use_clock(port_rt.VirtualClock()):
        with port_obs.span("a", dag="d1"):
            with port_obs.span("b"):
                pass
    text = fresh_obs.to_jsonl()
    assert len(text.splitlines()) == 2
    assert spans_from_jsonl(text) == fresh_obs.spans


def test_chrome_export_shape(fresh_obs):
    with use_clock(port_rt.VirtualClock()):
        with port_obs.span("replan", dag="d1"):
            port_obs.clock.sleep(0.25)
    doc = fresh_obs.to_chrome()
    assert doc["displayTimeUnit"] == "ms"
    (ev,) = doc["traceEvents"]
    assert (ev["ph"], ev["name"], ev["ts"], ev["dur"], ev["args"]) == \
        ("X", "replan", 0.0, 0.25 * 1e6, {"dag": "d1"})
    assert spans_to_chrome(fresh_obs.spans) == doc


def test_export_files_round_trip(tmp_path, fresh_obs):
    with port_obs.span("x"):
        pass
    jsonl, chrome = tmp_path / "spans.jsonl", tmp_path / "trace.json"
    assert port_obs.export_tracer(fresh_obs, jsonl=str(jsonl),
                                  chrome=str(chrome)) == 1
    assert port_obs.read_jsonl(str(jsonl)) == fresh_obs.spans
    assert len(json.loads(chrome.read_text())["traceEvents"]) == 1


def test_cli_smoke_writes_perfetto_json(tmp_path, capsys):
    from repro_torch.obs.__main__ import main
    out, jsonl = tmp_path / "obs_trace.json", tmp_path / "spans.jsonl"
    assert main(["export", "--smoke", "--out", str(out),
                 "--jsonl", str(jsonl)]) == 0
    doc = json.loads(out.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"controller.apply", "plan"} <= names
    out2 = tmp_path / "converted.json"
    assert main(["export", str(jsonl), "--out", str(out2)]) == 0
    assert json.loads(out2.read_text())["traceEvents"] == doc["traceEvents"]
    assert "tracer verified clean" in capsys.readouterr().out
    assert main(["export", "--out", str(tmp_path / "x.json")]) == 2


def test_cli_smoke_span_names_match_reference(tmp_path):
    """``python -m repro_torch.obs export --smoke`` in a process of its own
    writes the Perfetto JSON; its spans are the reference smoke's, by name
    and nesting depth."""
    docs = {}
    for which, module in (("port", "repro_torch.obs"), ("ref", "repro.obs")):
        out = tmp_path / f"{which}.json"
        proc = subprocess.run(
            [sys.executable, "-m", module, "export", "--smoke", "--out",
             str(out)], capture_output=True, text=True, timeout=300,
            env={"PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
                 "PATH": "/usr/bin:/bin"},
            cwd=str(__import__("pathlib").Path(__file__).parents[1]))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        docs[which] = json.loads(out.read_text())["traceEvents"]
    key = lambda e: (e["name"], e["args"].get("depth"))  # noqa: E731
    assert [e["name"] for e in docs["port"]] == [e["name"]
                                                  for e in docs["ref"]]
    assert sorted(map(str, map(key, docs["port"]))) == \
        sorted(map(str, map(key, docs["ref"])))


def test_execution_report_metrics(fresh_obs, libs):
    sched = port_core.plan(port_core.diamond_dag(), 80.0, libs["port"],
                           allocator="mba", mapper="sam")
    ex = port_rt.StreamExecutor(sched, libs["port"],
                                clock=port_rt.VirtualClock(), device="cpu")
    rep = ex.run(80.0, n_frames=6, batch=16)
    snap = port_obs.snapshot()
    assert snap["repro_frames_total"]["value"] == 6.0
    assert [s.name for s in fresh_obs.spans] == ["plan", "executor.run"]
    assert rep.frames == 6


def test_chaos_replay_span_timeline_deterministic(libs):
    def run():
        tracer = port_obs.Tracer(enabled=True)
        prev = port_obs.set_tracer(tracer)
        try:
            fleet = port_rt.LiveFleet(
                port_core.FleetController(libs["port"], budget_slots=BUDGET),
                fault_plan=port_rt.FaultPlan.from_seed(
                    7, dags=["d1", "d2"], tasks=["b", "c"],
                    horizon_frames=20, operator_errors=2, slowdowns=2,
                    drops=1),
                clock=port_rt.VirtualClock(), device="cpu")
            fleet.apply(port_core.DagArrive("d1", port_core.diamond_dag(),
                                            max_rate=80.0), at=0.0)
            fleet.apply(port_core.RateChange("d1", 50.0), at=1.0)
        finally:
            port_obs.set_tracer(prev)
        return tracer

    a, b = run(), run()
    assert len(a.signature()) > 0
    assert a.signature() == b.signature()
    assert port_analysis.verify_tracer(a) == []
    names = {s.name for s in a.spans}
    assert {"fleet.tick", "executor.run", "controller.apply"} <= names


# -- the profiler's trial runners ----------------------------------------------------

def test_trial_runner_virtual_mode_deterministic():
    def run_once(pkg_profiler, clock_cls):
        clock = clock_cls()
        runner = pkg_profiler.LiveTrialRunner(
            lambda: (lambda: None), clock=clock, trial_seconds=0.5,
            service_time=0.004)
        result = runner(2, 100.0)
        return (result.latencies, result.cpu, result.mem,
                result.supported_rate, clock.now())
    a = run_once(port_profiler, port_rt.VirtualClock)
    assert a == run_once(port_profiler, port_rt.VirtualClock)
    assert a == run_once(ref_profiler, ref_rt.VirtualClock)
    assert a[-1] > 0.0
    assert all(x == pytest.approx(0.004) for x in a[0])
    assert a[3] == pytest.approx(100.0, rel=0.05)


def test_trial_runner_through_the_clock_seam():
    with use_clock(port_rt.VirtualClock()):
        runner = port_profiler.LiveTrialRunner(
            lambda: (lambda: None), trial_seconds=0.5, service_time=0.002)
        assert runner(1, 50.0).supported_rate > 0.0
    runner = port_profiler.LiveTrialRunner(lambda: (lambda: None),
                                           clock=port_rt.VirtualClock())
    with pytest.raises(ValueError, match="service_time"):
        runner(1, 50.0)


def test_trial_runner_live_path_still_works():
    runner = port_profiler.LiveTrialRunner(lambda: (lambda: None),
                                           trial_seconds=0.05)
    result = runner(1, 200.0)
    assert result.supported_rate > 0.0
    assert 0.0 <= result.cpu <= 1.0
    assert len(result.latencies) > 0


@pytest.mark.parametrize("kind", ("parse_xml", "pi", "batch_file_write",
                                  "azure_blob", "azure_table"))
def test_analytic_profiles_match_reference(kind):
    port = port_profiler.profile_task(kind)
    ref = ref_profiler.profile_task(kind)
    assert port.kind == ref.kind and port.static == ref.static
    assert [dataclasses.astuple(p) for p in port.points] == \
        [dataclasses.astuple(p) for p in ref.points]


def test_profiled_library_matches_reference():
    port, ref = port_profiler.profiled_library(), ref_profiler.profiled_library()
    assert port.kinds() == ref.kinds()
    for kind in ref.kinds():
        assert [dataclasses.astuple(p) for p in port[kind].points] == \
            [dataclasses.astuple(p) for p in ref[kind].points]


# -- verifier passes: clean and mutated inputs, codes equal ---------------------------

def _mutate_tau_order(lib):
    lib["parse_xml"]._xp[2] = lib["parse_xml"]._xp[1]


def _mutate_negative(lib):
    lib["parse_xml"]._fp["cpu"][1] = -0.5


def _mutate_over_slot(lib):
    m = lib["parse_xml"]
    m.points[0] = dataclasses.replace(m.points[0], cpu=1.5)


def _mutate_zero_peak(lib):
    m = lib["parse_xml"]
    m.points[:] = [dataclasses.replace(p, rate=0.0) for p in m.points]


@pytest.mark.parametrize("mutate, expect", [
    (None, []), (_mutate_tau_order, ["MOD_TAU_ORDER"]),
    (_mutate_negative, ["MOD_NEGATIVE"]),
    (_mutate_over_slot, ["MOD_RES_OVER_SLOT"]),
    (_mutate_zero_peak, ["MOD_ZERO_PEAK"])],
    ids=["clean", "tau_order", "negative", "over_slot", "zero_peak"])
def test_verify_models_matches_reference(libs, mutate, expect):
    def run(which, core, rt, obs, analysis):
        lib = copy.deepcopy(libs[which])
        if mutate is not None:
            mutate(lib)
        return violations(analysis.verify_models(
            lib, kinds=None if mutate is None else ["parse_xml"],
            grid=np.linspace(10.0, 200.0, 20)))
    got = both(run)
    assert got["port"] == got["ref"]
    codes = [c for c, sev, *_ in got["port"] if sev == "error"
             or expect == ["MOD_RES_OVER_SLOT"]]
    assert codes == expect


def _live_fleet(which, lib):
    core, rt, _, _ = PKGS[which]
    kw = dict(device="cpu") if which == "port" else {}
    fleet = rt.LiveFleet(core.FleetController(lib, budget_slots=12),
                         fault_plan=rt.FaultPlan.none(),
                         clock=rt.VirtualClock(), frames_per_event=0, **kw)
    fleet.apply(core.DagArrive("d1", core.diamond_dag(), max_rate=80.0),
                at=0.0)
    return fleet


def _drop_op(fleet):
    ex = fleet.executors["d1"]
    del ex._ops[next(iter(ex._ops))]


def _copy_schedule(fleet):
    ex = fleet.executors["d1"]
    ex.schedule = copy.copy(ex.schedule)


def _drop_executor(fleet):
    del fleet.executors["d1"]


def _extra_executor(fleet):
    fleet.executors["ghost"] = fleet.executors["d1"]


def _drop_pin(fleet):
    ex = fleet.executors["d1"]
    del ex.slot_device[next(iter(ex.slot_device))]


def _drop_group(fleet):
    ex = fleet.executors["d1"]
    slot = next(iter(ex.slot_device))
    ex.groups = {t: {s: q for s, q in g.items() if s != slot}
                 for t, g in ex.groups.items()}


@pytest.mark.parametrize("mutate", [None, _drop_op, _copy_schedule,
                                    _drop_executor, _extra_executor,
                                    _drop_pin, _drop_group],
                         ids=["clean", "drop_op", "copy_schedule",
                              "drop_executor", "extra_executor", "drop_pin",
                              "drop_group"])
def test_verify_enactment_matches_reference(libs, mutate):
    def run(which, core, rt, obs, analysis):
        fleet = _live_fleet(which, libs[which])
        if mutate is not None:
            mutate(fleet)
        return violations(analysis.verify_enactment(fleet))
    got = both(run)
    assert got["port"] == got["ref"]
    assert [c for c, *_ in got["port"]] == (
        [] if mutate is None else
        ["EXE_DELTA_DIVERGED"] * len(got["port"]))
    assert mutate is None or got["port"]


def _calibration(which, lib):
    core = PKGS[which][0]
    ms = [core.TaskMeasurement(
        kind="parse_xml", task="b", tau=1, tuples=500.0,
        busy_seconds=500.0 / (0.5 * lib["parse_xml"].I(1)))]
    return core.recalibrate(lib, ms, alpha=0.9)


def _cal_nonmonotone(core, result):
    m = result.library["parse_xml"]
    pts = list(m.points)
    pts[0] = dataclasses.replace(pts[0], rate=pts[1].rate * 0.5)
    result.library._models["parse_xml"] = core.PerfModel(m.kind, pts,
                                                         static=m.static)


def _cal_grid(core, result):
    m = result.library["parse_xml"]
    result.library._models["parse_xml"] = core.PerfModel(
        m.kind, [dataclasses.replace(p, tau=p.tau + 1) for p in m.points],
        static=m.static)


def _cal_cpu(core, result):
    m = result.library["parse_xml"]
    result.library._models["parse_xml"] = core.PerfModel(
        m.kind, [dataclasses.replace(p, cpu=p.cpu * 0.5) for p in m.points],
        static=m.static)


def _cal_static(core, result):
    m = result.library["parse_xml"]
    result.library._models["parse_xml"] = core.PerfModel(
        m.kind, list(m.points), static=not m.static)


def _cal_kinds(core, result):
    del result.library._models["pi"]


@pytest.mark.parametrize("mutate", [None, _cal_nonmonotone, _cal_grid,
                                    _cal_cpu, _cal_static, _cal_kinds],
                         ids=["clean", "nonmonotone", "grid", "cpu", "static",
                              "kinds"])
def test_verify_calibration_matches_reference(libs, mutate):
    def run(which, core, rt, obs, analysis):
        result = _calibration(which, libs[which])
        assert result.per_kind["parse_xml"].changed
        if mutate is not None:
            mutate(core, result)
        return violations(analysis.verify_calibration(libs[which], result))
    got = both(run)
    assert got["port"] == got["ref"]
    codes = [c for c, *_ in got["port"]]
    assert codes == ([] if mutate is None else
                     ["CAL_TABLE_NONMONOTONE"] * len(codes)) and (
        mutate is None or codes)


def test_verify_tracer_unclosed_span_matches_reference():
    def run(which, core, rt, obs, analysis):
        tr = obs.Tracer(enabled=True)
        prev = obs.set_tracer(tr)
        try:
            with obs.span("ok"):
                pass
            leaked = obs.span("leaked")
            leaked.__enter__()          # mutation: never exited
            out = [v.code for v in analysis.verify_tracer(tr)]
            leaked.__exit__(None, None, None)
            return out + [len(analysis.verify_tracer(tr))]
        finally:
            obs.set_tracer(prev)
    got = both(run)
    assert got["port"] == got["ref"] == ["OBS_SPAN_UNCLOSED", 0]


def test_verify_tracer_clock_swap_matches_reference():
    def run(which, core, rt, obs, analysis):
        tr = obs.Tracer(enabled=True)
        s = tr.span("swapped")
        s.__enter__()                   # t0 from the wall clock
        with obs.clock.use_clock(rt.VirtualClock()):
            s.__exit__(None, None, None)  # t1 from a fresh virtual clock
        return [v.code for v in analysis.verify_tracer(tr)]
    got = both(run)
    assert got["port"] == got["ref"] == ["OBS_SPAN_NEGATIVE"]


@pytest.mark.parametrize("ticks, policy, expect", [
    ([0, 1], (0.1, 3), ["CAL_AUTO_RECAL_LOOP"]),
    ([0, 5], (0.1, 3), []),
    ([0, 1], None, []),
    ([0, 2, 3, 9], (0.1, 2), ["CAL_AUTO_RECAL_LOOP"]),
])
def test_verify_autorecal_matches_reference(ticks, policy, expect):
    def run(which, core, rt, obs, analysis):
        pol = (None if policy is None else
               core.AutoRecalPolicy(threshold=policy[0],
                                    cooldown_events=policy[1]))
        return violations(analysis.verify_autorecal(
            SimpleNamespace(auto_recal=pol, recal_ticks=list(ticks))))
    got = both(run)
    assert got["port"] == got["ref"]
    assert [c for c, *_ in got["port"]] == expect


def test_auto_recal_policy_checks_its_knobs():
    for kw in (dict(smoothing=0.0), dict(threshold=-1.0),
               dict(cooldown_events=0)):
        with pytest.raises(ValueError):
            port_core.AutoRecalPolicy(**kw)
