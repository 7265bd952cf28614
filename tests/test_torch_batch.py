"""The port's vectorized batch planner (``core/batch.py``) and
``max_planned_rate`` against the reference's, on the CPU.

Both packages evaluate the same DAGs over the same rate grids with their
own copies of the planner core; every array and every answer must be equal
(``batch.py`` is numpy only, so equal means bit for bit), on the cases of
tests/test_batch.py.  The bisection helpers must also probe the same
indices in the same order.
"""

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core import batch as ref_batch
from repro.core import scheduler as ref_scheduler
from repro_torch.core import batch as port_batch
from repro_torch.core import scheduler as port_scheduler

DAGS = sorted(port.ALL_DAGS)
PAIRS = (("lsa", "dsm"), ("lsa", "rsm"),
         ("mba", "dsm"), ("mba", "rsm"), ("mba", "sam"))
GRID = np.arange(10.0, 510.0, 10.0)


@pytest.fixture(scope="module")
def libs():
    return port.paper_library(), ref.paper_library()


def _degenerate(pkg, peak):
    """tests/test_allocation.py's dead task (peak 0: no rate is
    supportable) or test_batch.py's near-degenerate one (a tiny peak)."""
    models = pkg.ModelLibrary({
        "t": pkg.PerfModel.from_points("t", {1: (peak, 0.5, 0.5)}),
        "source": pkg.PAPER_MODELS["source"],
        "sink": pkg.PAPER_MODELS["sink"]})
    df = pkg.Dataflow("degenerate")
    df.add_task("src", "source", is_source=True)
    df.add_task("t", "t")
    df.add_task("snk", "sink", is_sink=True)
    df.add_edge("src", "t")
    df.add_edge("t", "snk")
    return df, models


@pytest.mark.parametrize("algo", ["lsa", "mba"])
@pytest.mark.parametrize("dag", DAGS)
def test_batch_allocate_equals_reference(libs, dag, algo):
    lib, jlib = libs
    a = port.batch_allocate(port.ALL_DAGS[dag](), GRID, lib, algo)
    b = ref.batch_allocate(ref.ALL_DAGS[dag](), GRID, jlib, algo)
    assert a.task_names == b.task_names
    for f in ("omegas", "rates", "threads", "cpu", "mem", "slots"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("speed, mem", [(1.0, 1.0), (2.0, 1.0), (1.0, 0.5)])
@pytest.mark.parametrize("dag", ["linear", "traffic", "grid"])
def test_batch_slots_equals_reference(libs, dag, speed, mem):
    lib, jlib = libs
    grid = np.arange(10.0, 3010.0, 10.0)      # past every DAG's ceiling
    a = port.batch_slots(port.ALL_DAGS[dag](), grid, lib, "mba",
                         clip_unsupportable=True, speed=speed,
                         mem_per_slot=mem)
    b = ref.batch_slots(ref.ALL_DAGS[dag](), grid, jlib, "mba",
                        clip_unsupportable=True, speed=speed,
                        mem_per_slot=mem)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("budget", [8, 20])
def test_batch_feasible_equals_reference(libs, budget):
    lib, jlib = libs
    omegas = np.arange(10.0, 310.0, 10.0)
    a = port.batch_feasible({n: mk() for n, mk in port.MICRO_DAGS.items()},
                            omegas, lib, algorithm="mba", budget_slots=budget)
    b = ref.batch_feasible({n: mk() for n, mk in ref.MICRO_DAGS.items()},
                           omegas, jlib, algorithm="mba", budget_slots=budget)
    assert a.keys() == b.keys()
    for n in a:
        assert np.array_equal(a[n], b[n]), n


@pytest.mark.parametrize("peak", [0.0, 1e-19])
def test_degenerate_profiles_equal_reference(peak):
    """A task no rate fits (typed error, clipped to infeasible) and one
    whose thread count would wrap an int64 (clamped) read the same."""
    (df, models), (jdf, jmodels) = _degenerate(port, peak), \
        _degenerate(ref, peak)
    if peak == 0.0:
        with pytest.raises(port.UnsupportableRateError):
            port.batch_allocate(df, [10.0], models, "mba")
    for algo in ("lsa", "mba"):
        a = port.batch_allocate(df, [10.0, 20.0], models, algo,
                                clip_unsupportable=True)
        b = ref.batch_allocate(jdf, [10.0, 20.0], jmodels, algo,
                               clip_unsupportable=True)
        for f in ("threads", "cpu", "mem", "slots"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (algo, f)
    a = port.batch_feasible({"d": df}, [10.0, 20.0], models,
                            budget_slots=10 ** 6)
    assert not a["d"].any()
    for method in ("scan", "bisect"):
        assert port_scheduler.max_planned_rate(
            df, models, allocator="mba", mapper="sam", budget_slots=20,
            method=method) == 0.0


MASKS = [[], [False] * 5, [True], [False], [True] * 7] + [
    [True] * n + [False] * (7 - n) for n in range(1, 7)]


@pytest.mark.parametrize("lo_known_true", [False, True])
@pytest.mark.parametrize("mask", MASKS, ids=lambda m: "".join(
    "1" if x else "0" for x in m) or "empty")
def test_bisect_largest_true_equals_reference(mask, lo_known_true):
    if lo_known_true and not (mask and mask[0]):
        mask = [True] + list(mask)
    got, want = [], []

    def probe(log):
        return lambda i: log.append(i) or mask[i]

    a = port_batch.bisect_largest_true(probe(got), len(mask),
                                       lo_known_true=lo_known_true)
    b = ref_batch.bisect_largest_true(probe(want), len(mask),
                                      lo_known_true=lo_known_true)
    assert a == b and got == want


@pytest.mark.parametrize("mask", [[], [True] * 9, [False] * 9,
                                  [True, False, True],
                                  [True, True, False, False]])
def test_prefix_feasible_count_equals_reference(mask):
    m = np.array(mask, dtype=bool)
    assert port_batch.prefix_feasible_count(m) == \
        ref_batch.prefix_feasible_count(m)


@pytest.mark.parametrize("method", ["scan", "bisect"])
@pytest.mark.parametrize("dag", DAGS)
def test_max_planned_rate_equals_reference(libs, dag, method):
    """The §8.5 rate for a 20-slot budget under every scheduler pair, and
    the allocator and mapper calls that found it."""
    lib, jlib = libs
    for alloc, mapper in PAIRS:
        s_port, s_ref = {}, {}
        a = port_scheduler.max_planned_rate(
            port.ALL_DAGS[dag](), lib, allocator=alloc, mapper=mapper,
            budget_slots=20, method=method, stats=s_port)
        b = ref_scheduler.max_planned_rate(
            ref.ALL_DAGS[dag](), jlib, allocator=alloc, mapper=mapper,
            budget_slots=20, method=method, stats=s_ref)
        assert a == b and s_port == s_ref, (alloc, mapper)


def test_max_planned_rate_zero_when_nothing_fits(libs):
    lib, _ = libs
    for method in ("scan", "bisect"):
        assert port_scheduler.max_planned_rate(
            port.grid_dag(), lib, allocator="mba", mapper="sam",
            budget_slots=1, method=method) == 0.0
    with pytest.raises(ValueError):
        port_scheduler.max_planned_rate(port.linear_dag(), lib,
                                        allocator="mba", mapper="sam",
                                        budget_slots=4, method="nope")
