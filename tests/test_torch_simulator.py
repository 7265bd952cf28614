"""The port's fluid simulator against the reference's numpy engine, and its
sweep kernel against the kernel's plain version on the card.

Both packages plan the same seed DAG (``mba``/``sam`` at 100 t/s) with their
own copies of the planner, so the sweep specs are compared first: row
spans, in-edges, routing fractions, slot and task ids, flat hops, sink rows
and the capacity matrix must be equal.  Then every ``SweepRaw`` field of
the port's ``numpy`` engine and of its ``scan`` engine on ``device="cpu"``
(the sweep kernel's plain PyTorch version) must lie within 1e-10 of the
reference's ``engine="numpy"`` (the tolerance of
tests/test_simulator_scan.py), and the judged ``SimResult``s must agree as
that file asks.  The reference's own ``scan`` engine is not run: it needs
``jax.experimental.enable_x64``, which the installed JAX lacks.

The ``cuda`` tests hold the CUDA kernel against the plain version on the
card at the same tolerance; the GPU machine has no JAX, so they run there
with ``--noconftest -m cuda`` (``repro.core`` itself loads without JAX).
"""

import itertools
from fractions import Fraction

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch import obs
from repro_torch.core import simulator as port_sim
from repro_torch.core.predictor import effective_capacity_matrix
from repro_torch.kernels.sweep_scan import kernel as sweep_kernel
from repro_torch.kernels.sweep_scan import ops as sweep_ops
from repro_torch.kernels.sweep_scan.ref import (full_counts, pack_structure,
                                                sweep_scan_reference)

RAW_FIELDS = ("queues", "busy", "served", "realized", "latency")
DAGS = sorted(port.ALL_DAGS)
POLICIES = [p.value for p in port.RoutingPolicy]
ENGINES = ["numpy", "scan"]
OMEGAS = np.linspace(20.0, 200.0, 10)
KW = dict(duration=8.0, dt=0.1)
TOL = 1e-10


@pytest.fixture(scope="module")
def libs():
    return port.paper_library(), ref.paper_library()


def _sims(libs, dag, policy="shuffle", omega=100.0):
    """(port simulator on the CPU, reference simulator) of the same plan."""
    lib, jlib = libs
    ps = port.plan(port.ALL_DAGS[dag](), omega, lib, allocator="mba",
                   mapper="sam")
    rs = ref.plan(ref.ALL_DAGS[dag](), omega, jlib, allocator="mba",
                  mapper="sam")
    ours = port.DataflowSimulator(ps.dag, ps.allocation, ps.mapping, lib,
                                  policy=port.RoutingPolicy(policy),
                                  device="cpu")
    theirs = ref.DataflowSimulator(rs.dag, rs.allocation, rs.mapping, jlib,
                                   policy=ref.RoutingPolicy(policy))
    return ours, theirs


def _slot_key(slot):
    return (slot.vm, slot.slot)


def assert_specs_equal(ours, theirs):
    """Two SweepBatch specs (and flat hops) are equal, field by field."""
    a, b = ours.spec, theirs.spec
    assert a.row_slices == b.row_slices
    assert a.in_edges == b.in_edges
    assert a.hops == b.hops
    assert a.sink_groups == b.sink_groups
    for f in ("g_frac", "g_slot", "g_task"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    np.testing.assert_array_equal(ours._hops_flat, theirs._hops_flat)
    assert [_slot_key(s) for s in a.slots] == [_slot_key(s) for s in b.slots]


def assert_raw_close(a, b, tol=TOL):
    for f in RAW_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape, f
        if x.size:
            np.testing.assert_allclose(x, y, rtol=tol, atol=tol, err_msg=f)
    np.testing.assert_array_equal(a.sample_times, b.sample_times)
    assert (a.steps, a.s0, a.dt, a.window) == (b.steps, b.s0, b.dt, b.window)


def assert_results_close(ra, rb):
    """SimResults agree as tests/test_simulator_scan.py asks of its engines
    (stability verdicts exactly)."""
    assert ra.omega == rb.omega
    assert ra.stable == rb.stable
    assert ra.latency_slope == pytest.approx(rb.latency_slope, abs=TOL)
    assert ra.mean_latency == pytest.approx(rb.mean_latency, abs=TOL)
    assert ra.p99_latency == pytest.approx(rb.p99_latency, abs=TOL)
    assert ra.queue_total == pytest.approx(rb.queue_total, rel=TOL, abs=TOL)
    np.testing.assert_allclose(ra.latency_samples, rb.latency_samples,
                               rtol=TOL, atol=TOL)
    busy_a = {_slot_key(s): v for s, v in ra.slot_busy.items()}
    busy_b = {_slot_key(s): v for s, v in rb.slot_busy.items()}
    assert busy_a.keys() == busy_b.keys()
    for slot, busy in busy_b.items():
        assert busy_a[slot] == pytest.approx(busy, abs=TOL)


# -- the plan and its spec cross over unchanged --------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dag", DAGS)
def test_specs_and_capacities_equal(libs, dag, policy):
    ours, theirs = _sims(libs, dag, policy)
    assert_specs_equal(port.SweepBatch([ours]), ref.SweepBatch([theirs]))
    from repro.core.predictor import \
        effective_capacity_matrix as ref_capacity_matrix
    np.testing.assert_array_equal(
        effective_capacity_matrix(ours.gi, OMEGAS, cpu_penalty=True),
        ref_capacity_matrix(theirs.gi, OMEGAS, cpu_penalty=True))


# -- engine parity with the reference's numpy engine ---------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dag", DAGS)
def test_sweep_matches_reference_numpy(libs, dag, policy, engine):
    """Raw state within 1e-10 over a sweep spanning stable and overloaded
    rates, and the judged SimResults field by field."""
    ours, theirs = _sims(libs, dag, policy)
    want = theirs.sweep_raw(OMEGAS, engine="numpy", **KW)
    assert_raw_close(ours.sweep_raw(OMEGAS, engine=engine, **KW), want)
    for ra, rb in zip(ours.simulate_sweep(OMEGAS, engine=engine, **KW),
                      theirs.simulate_sweep(OMEGAS, engine="numpy", **KW)):
        assert_results_close(ra, rb)


@pytest.mark.parametrize("engine", ENGINES)
def test_run_is_the_k1_column(libs, engine):
    """``run(omega)`` is the K = 1 sweep: it equals the reference's run and
    the same rate's column of a wider sweep."""
    ours, theirs = _sims(libs, "linear")
    kw = dict(duration=6.0, dt=0.1)
    a = ours.run(90.0, engine=engine, **kw)
    assert_results_close(a, theirs.run(90.0, engine="numpy", **kw))
    col = ours.simulate_sweep([30.0, 90.0, 150.0], engine=engine, **kw)[1]
    assert_results_close(a, col)


@pytest.mark.parametrize("dag", ["linear", "diamond", "finance"])
def test_max_stable_rate_equals_reference(libs, dag):
    ours, theirs = _sims(libs, dag)
    got = ours.max_stable_rate(duration=8.0, dt=0.1)
    assert got == theirs.max_stable_rate(duration=8.0, dt=0.1,
                                         engine="numpy")
    assert got > 0


# -- co-simulation on a shared slot pool ---------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_cosim_busy_adds_on_shared_slots(libs, engine):
    """The same mapping co-simulated twice accumulates busy time on the
    shared slots additively."""
    ours, _ = _sims(libs, "linear")
    twin, _ = _sims(libs, "linear")
    kw = dict(duration=4.0, dt=0.1, engine=engine, device="cpu")
    solo = port.SweepBatch([ours]).sweep_raw([[50.0]], **kw)
    both = port.SweepBatch([ours, twin]).sweep_raw([[50.0], [50.0]], **kw)
    assert len(both.busy) == len(solo.busy)       # slots deduplicated
    np.testing.assert_allclose(both.busy, 2 * solo.busy, rtol=1e-12)


@pytest.mark.parametrize("policy", POLICIES)
def test_cosim_of_two_dags_matches_reference(libs, policy):
    """Two DAGs planned on overlapping VM ids share slots; one co-simulated
    sweep through the plain version matches the reference's numpy engine."""
    pairs = [_sims(libs, d, policy) for d in ("linear", "diamond")]
    ours = port.SweepBatch([p for p, _ in pairs])
    theirs = ref.SweepBatch([r for _, r in pairs])
    assert_specs_equal(ours, theirs)
    grids = [OMEGAS, OMEGAS * 0.8]
    assert_raw_close(ours.sweep_raw(grids, device="cpu", **KW),
                     theirs.sweep_raw(grids, engine="numpy", **KW))
    for per_a, per_b in zip(ours.simulate(grids, device="cpu", **KW),
                            theirs.simulate(grids, engine="numpy", **KW)):
        for ra, rb in zip(per_a, per_b):
            assert_results_close(ra, rb)


# -- the structure cache and its obs bridge ------------------------------------

def test_structure_cache_hits_on_second_run(libs):
    ours, _ = _sims(libs, "star")
    ours.sweep_raw(OMEGAS, **KW)
    before = port_sim.scan_kernel_cache_stats()
    assert set(before) == {"entries", "hits", "misses", "compiled"}
    ours.sweep_raw(OMEGAS, **KW)
    after = port_sim.scan_kernel_cache_stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    assert after["entries"] == before["entries"]
    assert after["compiled"] == before["compiled"]


def test_cache_gauges_published_to_obs(libs):
    ours, _ = _sims(libs, "diamond")
    ours.sweep_raw(OMEGAS, **KW)
    obs.REGISTRY.reset()
    obs.enable_metrics()
    try:
        snap = obs.snapshot()
        stats = port_sim.scan_kernel_cache_stats()
    finally:
        obs.disable_metrics()
        obs.REGISTRY.reset()
    assert snap["repro_scan_kernel_cache_entries"]["value"] == float(
        stats["entries"])
    assert snap["repro_scan_kernel_cache_hits_total"]["value"] == float(
        stats["hits"])
    assert snap["repro_scan_kernel_cache_misses_total"]["value"] == float(
        stats["misses"])
    lookups = stats["hits"] + stats["misses"]
    assert snap["repro_scan_kernel_cache_hit_ratio"]["value"] == \
        pytest.approx(stats["hits"] / lookups)


# -- devices and engine names --------------------------------------------------

def test_default_device_without_cuda_raises(libs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lib, _ = libs
    s = port.plan(port.ALL_DAGS["linear"](), 100, lib)
    sim = port.DataflowSimulator(s.dag, s.allocation, s.mapping, lib)
    assert sim.engine == "scan"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.sweep_raw([50.0], duration=1.0, dt=0.1)
    # the host loop needs no device
    assert sim.sweep_raw([50.0], duration=1.0, dt=0.1,
                         engine="numpy").steps == 10


def test_unknown_engine_and_device_rejected(libs):
    ours, _ = _sims(libs, "linear")
    with pytest.raises(ValueError, match="unknown simulator engine"):
        ours.sweep_raw([50.0], engine="lax", duration=1.0, dt=0.1)
    s = port.plan(port.ALL_DAGS["linear"](), 100, libs[0])
    with pytest.raises(ValueError, match="unknown simulator engine"):
        port.DataflowSimulator(s.dag, s.allocation, s.mapping, libs[0],
                               engine="vmap")
    structure = pack_structure([(0, 1)], [[]], [[0]], 1, torch.device("cpu"))
    args = (torch.ones((1, 1, 1), dtype=torch.float64, device="meta"),) + \
        tuple(torch.zeros(shape, dtype=dt, device="meta") for shape, dt in (
            ((1, 1), torch.float64), ((1, 1), torch.float64),
            ((1, 1), torch.int32), ((1, 0), torch.float64),
            ((1, 1), torch.int32)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sweep_ops.sweep_scan(*args, structure, steps=1, sample_every=1, s0=0,
                             dt=0.1)


def test_pack_structure_checks_the_structure():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="tile"):
        pack_structure([(0, 2), (3, 4)], [[], [(0, 1.0)]], [[1]], 2, cpu)
    with pytest.raises(ValueError, match="not a task row"):
        pack_structure([(0, 1), (1, 2)], [[], [(5, 1.0)]], [[1]], 2, cpu)
    s = pack_structure([(0, 2), (2, 2), (2, 3)],
                       [[], [(0, 1.0)], [(0, 2.0), (1, 0.5)]], [[2], []], 3,
                       cpu)
    assert s.row_off.tolist() == [0, 2, 2, 3]
    assert s.edge_off.tolist() == [0, 0, 1, 3]
    assert s.edge_src.tolist() == [0, 0, 1]
    assert s.edge_mult.tolist() == [1.0, 2.0, 0.5]
    assert s.sink_off.tolist() == [0, 1, 1]
    assert s.sink_rows.tolist() == [2]
    assert s.g_task.tolist() == [0, 0, 2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_index_keeps_group_order_within_each_slot(seed):
    """The busy scatter's index: each slot's live groups in ascending group
    order (np.add.at's order), groups that are not live past the last
    slot."""
    rng = np.random.default_rng(seed)
    C, G, S = 4, 75, 9
    g_slot = torch.as_tensor(rng.integers(0, S, (C, G)), dtype=torch.int32)
    live = torch.as_tensor(rng.random((C, G)) < 0.8)
    off, grp = sweep_kernel.slot_index(g_slot, live, S)
    assert off.dtype == grp.dtype == torch.int32
    assert off.shape == (C, S + 1) and grp.shape == (C, G)
    for c in range(C):
        for s in range(S):
            assert grp[c, off[c, s]:off[c, s + 1]].tolist() == [
                g for g in range(G) if live[c, g] and g_slot[c, g] == s]
        assert int(off[c, S]) == int(live[c].sum())
        assert sorted(grp[c].tolist()) == list(range(G))


@pytest.mark.parametrize("G, S, T, E, L, K, every, warps, skew", [
    (47, 39, 17, 21, 47, 50, 5, 3, 5),       # the grid sweep
    (296, 64, 17, 21, 200, 11, 2, 1, 2),     # the grid search's widest bucket
    (8, 4, 7, 6, 8, 3, 2, 3, 2),             # fewer columns than warps
    (47, 39, 17, 21, 47, 50, 1, 4, 1),       # a sample every tick
    (47, 39, 17, 21, 47, 50, 100, 4, 1),     # rings too deep to align samples
    (300, 64, 17, 21, 300, 50, 40, 2, 1),    # skew 1, three columns do not fit
    (600, 64, 17, 21, 400, 50, 40, 1, 1),    # one column only
])
def test_launch_shape_fits_the_block(G, S, T, E, L, K, every, warps, skew):
    got = sweep_kernel.launch_shape(G, S, T, E, 1, 1, L, K, every)
    assert got[:2] == (warps, skew)
    assert got[2] == sweep_kernel.shared_bytes(G, S, T, E, 1, 1, L, skew,
                                               warps)
    assert got[2] <= sweep_kernel.MAX_SHARED_BYTES
    if skew < every:
        assert sweep_kernel.shared_bytes(G, S, T, E, 1, 1, L, every, 1) > \
            sweep_kernel.MAX_SHARED_BYTES
    if warps < min(sweep_kernel.MAX_WARPS, K):
        assert sweep_kernel.shared_bytes(G, S, T, E, 1, 1, L, skew,
                                         warps + 1) > \
            sweep_kernel.MAX_SHARED_BYTES


def test_launch_shape_raises_when_one_column_does_not_fit():
    """A structure whose single rate column's state exceeds the 227 KB a
    block can have, even at skew 1, is no longer refused: its launch lays
    the same state out in device memory (skew sample_every, every warp)."""
    G, S, T, E, L = 1200, 64, 17, 21, 800
    assert sweep_kernel.shared_bytes(G, S, T, E, 1, 1, L, 1, 1) > \
        sweep_kernel.MAX_SHARED_BYTES
    got = sweep_kernel.launch_shape(G, S, T, E, 1, 1, L, 50, 5)
    assert got == (sweep_kernel.MAX_WARPS, 5,
                   sweep_kernel.shared_bytes(G, S, T, E, 1, 1, L, 5,
                                             sweep_kernel.MAX_WARPS),
                   "device")


@pytest.mark.parametrize("n, depth", [(1, 1), (2, 2), (7, 8), (16, 16),
                                      (17, 32), (81, 128)])
def test_ring_depth_is_the_least_power_of_two(n, depth):
    assert sweep_kernel.ring_depth(n) == depth


def test_kernel_needs_rows_in_topological_order():
    """The wavefront reads a source row's rate of the same tick, so an
    in-edge from the same or a later row is refused; the seed DAGs' specs
    pass."""
    cpu = torch.device("cpu")
    sweep_kernel.check_row_order(pack_structure(
        [(0, 1), (1, 2), (2, 3)], [[], [(0, 1.0)], [(0, 1.0), (1, 2.0)]],
        [[2]], 1, cpu))
    with pytest.raises(ValueError, match="topological"):
        sweep_kernel.check_row_order(pack_structure(
            [(0, 1), (1, 2)], [[(1, 1.0)], []], [[0]], 1, cpu))
    with pytest.raises(ValueError, match="topological"):
        sweep_kernel.check_row_order(pack_structure(
            [(0, 1), (1, 2)], [[], [(1, 1.0)]], [[1]], 1, cpu))


@pytest.mark.parametrize("dag", DAGS)
def test_seed_specs_are_in_topological_order(libs, dag):
    ours, _ = _sims(libs, dag)
    spec = port.SweepBatch([ours]).spec
    sweep_kernel.check_row_order(pack_structure(
        spec.row_slices, spec.in_edges, spec.sink_groups, len(spec.slots),
        torch.device("cpu")))


def _fma(x: float, y: float, z: float) -> float:
    """x * y + z rounded once, as the card's FMA rounds it."""
    return float(Fraction(x) * Fraction(y) + Fraction(z))


def _div_by(a: float, b: float) -> float:
    """``sweep_scan.cu::div_by`` on the fast path: y = RN(1/b), q = RN(a y)
    and two corrections q += (a - b q) y, each an FMA."""
    y = float(1 / Fraction(b))
    q = a * y
    q = _fma(_fma(-b, q, a), y, q)
    return _fma(_fma(-b, q, a), y, q)


@pytest.mark.parametrize("seed, divisor", enumerate([
    0.05, 0.1, 0.25, 0.3, 1 / 3, 7.0, 123.456, 2 - 2 ** -50, "random"]))
def test_reciprocal_division_rounds_correctly(seed, divisor):
    """The kernel divides by dt and by caps through the divisor's
    reciprocal and two exact FMA corrections; the quotient must be the
    correctly rounded one numpy's division gives, here against exact
    rational arithmetic: random numerators over 80 binades, numerators of
    quotients that sit half an ulp from a double, and integer-like ones."""
    rng = np.random.default_rng(seed)
    for i in range(3000):
        b = divisor if divisor != "random" else float(
            np.ldexp(1 + rng.random(), int(rng.integers(-40, 40))))
        a = float(np.ldexp(1 + rng.random(), int(rng.integers(-40, 40))))
        if i % 3 == 1:   # the quotient half an ulp above a double
            q = float(Fraction(a) / Fraction(b))
            a = float((Fraction(q) + Fraction(np.spacing(q)) / 2)
                      * Fraction(b))
        elif i % 3 == 2:
            a = float(rng.integers(0, 10 ** 6)) * 10.0 ** int(
                rng.integers(-6, 4))
        assert _div_by(a, b) == float(Fraction(a) / Fraction(b)), (a, b)


def test_plain_version_rejects_bad_counts():
    s = pack_structure([(0, 2), (2, 3)], [[], [(0, 1.0)]], [[1]], 1,
                       torch.device("cpu"))
    f64 = dict(dtype=torch.float64)
    args = (torch.ones((1, 3, 2), **f64), torch.ones((2, 2), **f64),
            torch.ones((1, 3), **f64), torch.zeros((1, 3), dtype=torch.int32),
            torch.zeros((1, 1), **f64))
    for counts in ([[3, 1]], [[-1, 1]], [[2, 1, 0]]):
        with pytest.raises(ValueError, match="counts"):
            sweep_scan_reference(*args, torch.tensor(counts, dtype=torch.int32),
                                 s, steps=2, sample_every=1, s0=0, dt=0.1)


def test_plain_version_rejects_out_of_range_slots():
    s = pack_structure([(0, 1)], [[]], [[0]], 1, torch.device("cpu"))
    f64 = dict(dtype=torch.float64)
    with pytest.raises(ValueError, match="slot outside"):
        sweep_scan_reference(torch.ones((1, 1, 2), **f64),
                             torch.ones((1, 2), **f64),
                             torch.ones((1, 1), **f64),
                             torch.full((1, 1), 3, dtype=torch.int32),
                             torch.zeros((1, 0), **f64), full_counts(s, 1),
                             s, steps=2, sample_every=1, s0=0, dt=0.1)


# -- on the card: the CUDA kernel against its plain version --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dag", DAGS)
def test_cuda_kernel_matches_plain(libs, dag):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    ours, _ = _sims(libs, dag, "slot_aware")
    dev = torch.device("cuda")
    b = port.SweepBatch([ours])
    spec = b.spec
    caps = effective_capacity_matrix(ours.gi, OMEGAS, cpu_penalty=True)
    src = ours.gi.betas[:, None] * OMEGAS[None, :]
    steps, every, s0 = port_sim._sweep_steps(20.0, 0.05, 5.0, 0.25)
    args = [(caps[None], torch.float64), (src, torch.float64),
            (spec.g_frac[None], torch.float64),
            (spec.g_slot[None], torch.int32),
            (b._hops_flat[None], torch.float64)]
    kw = dict(steps=steps, sample_every=every, s0=s0, dt=0.05)
    structure = pack_structure(spec.row_slices, spec.in_edges,
                               spec.sink_groups, len(spec.slots), dev)
    tensors = [torch.as_tensor(np.ascontiguousarray(a), dtype=t, device=dev)
               for a, t in args] + [full_counts(structure, 1)]
    before = sweep_kernel.launch_count()
    got = sweep_ops.sweep_scan(*tensors, structure, **kw)
    torch.cuda.synchronize()
    assert sweep_kernel.launch_count() == before + 1
    want = sweep_scan_reference(*tensors, structure, **kw)
    for f, x, y in zip(RAW_FIELDS, got, want):
        assert x.shape == y.shape, f
        torch.testing.assert_close(x, y, rtol=TOL, atol=TOL, msg=f)


@pytest.mark.cuda
def test_cuda_simulator_matches_reference_numpy(libs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    ours, theirs = _sims(libs, "grid")
    ours.device = None
    before = sweep_kernel.launch_count()
    got = ours.sweep_raw(OMEGAS, **KW)
    assert sweep_kernel.launch_count() == before + 1
    assert_raw_close(got, theirs.sweep_raw(OMEGAS, engine="numpy", **KW))
    assert port_sim.scan_kernel_cache_stats()["compiled"] == 1


# -- fleets: a wavefront per DAG -------------------------------------------------

#: (DAGs, slot budget) of the stacked fleets the co-simulation must run:
#: benchmarks/bench_fleet.py's largest, two past it that fit one block's
#: shared memory, and one whose state goes to device memory
FLEETS = {6: 64, 8: 96, 12: 128, 24: 256}


@pytest.fixture(scope="module")
def fleet_batches(libs):
    """{size: (SweepBatch on the CPU, planned rates)} of ``plan_fleet``
    (max_min, sam) over bench_fleet.py's cycled seed DAGs."""
    lib, _ = libs
    out = {}
    for size, budget in FLEETS.items():
        names = itertools.islice(itertools.cycle(port.ALL_DAGS), size)
        fp = port.plan_fleet({f"{n}{i}": port.ALL_DAGS[n]()
                              for i, n in enumerate(names)}, lib,
                             budget_slots=budget, objective="max_min",
                             mapper="sam")
        mapped = [e for e in fp.entries.values() if e.schedule is not None]
        assert len(mapped) == size
        out[size] = (port.SweepBatch([
            port.DataflowSimulator(e.dag, e.schedule.allocation,
                                   e.schedule.mapping, lib, device="cpu")
            for e in mapped]), np.array([e.omega for e in mapped]))
    return out


def _fleet_shape(batch, K, sample_every, **kw):
    spec = batch.spec
    return sweep_kernel.launch_shape(
        spec.n_groups, len(spec.slots), spec.n_rows,
        sum(len(e) for e in spec.in_edges), len(spec.sink_groups),
        sum(len(r) for r in spec.sink_groups), spec.n_groups, K,
        sample_every, **kw)


def test_segment_lags_restart_at_each_dag(fleet_batches):
    """Each DAG of a stacked batch is one segment: a row's lag is its index
    within its own DAG, and the longest segment is the largest DAG."""
    batch, _ = fleet_batches[8]
    s = pack_structure(batch.spec.row_slices, batch.spec.in_edges,
                       batch.spec.sink_groups, len(batch.spec.slots),
                       torch.device("cpu"))
    want = [r - lo for lo, hi in batch.row_spans for r in range(lo, hi)]
    assert s.row_lag.tolist() == list(s.row_lags) == want
    assert s.lag_rows == max(hi - lo for lo, hi in batch.row_spans) == 17
    sweep_kernel.check_row_order(s)


def test_check_row_order_refuses_an_edge_across_segments():
    cpu = torch.device("cpu")
    s = pack_structure([(0, 1), (1, 2), (2, 3)], [[], [], [(1, 1.0)]],
                       [[2]], 1, cpu)
    assert s.row_lags == (0, 0, 1) and s.lag_rows == 2
    object.__setattr__(s, "in_edges", ((), (), ((0, 1.0),)))
    with pytest.raises(ValueError, match="segment"):
        sweep_kernel.check_row_order(s)


@pytest.mark.parametrize("size", [8, 12, 24])
def test_launch_shape_fits_stacked_fleets(fleet_batches, size):
    """8 and 12 stacked seed-DAG plans fit one block's shared memory with a
    wavefront per DAG (with one wavefront over all rows they did not); 24
    do not, and their launch lays its state out in device memory."""
    steps, every, s0 = port_sim._sweep_steps(20.0, 0.05, 5.0, 0.25)
    batch, _ = fleet_batches[size]
    warps, skew, nbytes, where = _fleet_shape(batch, 9, every, lag_rows=17)
    assert _fleet_shape(batch, 9, every, lag_rows=batch.spec.n_rows)[3] == \
        "device"
    if size == 24:
        assert (warps, skew, where) == (4, every, "device")
        assert nbytes > sweep_kernel.MAX_SHARED_BYTES
    else:
        assert where == "shared" and nbytes <= sweep_kernel.MAX_SHARED_BYTES
        assert warps >= 1 and skew in (1, every)


def _wave_model(structure, caps, src, frac, slot, hops, *, steps,
                sample_every, s0, dt, skew):
    """``sweep_scan.cu``'s wave schedule for one candidate, all K columns
    at once, in numpy: row r advances tick w - skew * lag in wave w, and
    rings of the kernel's depths start as NaN.  Every ring entry carries
    the tick (or sample) that wrote it, and every read asserts it finds the
    one it wants, so a ring too shallow for the lags fails whatever the
    data.  The lanes of a wave run together, so no ring entry a row reads
    in a wave may be written in the same wave by another row (asserted:
    that would be a race); the busy adds and the output samples run after
    the rows, as after the kernel's __syncwarp."""
    rows, edges = structure.row_slices, structure.in_edges
    lag, TL = structure.row_lags, structure.lag_rows
    T, (G, K), S = len(rows), caps.shape, structure.n_slots
    DR = sweep_kernel.ring_depth(skew * (TL - 1) + 1)
    DB = sweep_kernel.ring_depth(TL)
    order = np.argsort(slot, kind="stable")
    pos = np.empty(G, dtype=int)
    pos[order] = np.arange(G)
    s_off = np.concatenate([[0], np.cumsum(np.bincount(slot, minlength=S))])
    e_off = np.concatenate([[0], np.cumsum([len(e) for e in edges])])
    k_last = [max((lag[r] for r in rs), default=0)
              for rs in structure.sink_groups]
    queue, acc, bsy = np.zeros((G, K)), np.zeros((G, K)), np.zeros((S, K))
    capdt = caps * dt
    ring_r = np.full((T, DR, K), np.nan)
    ring_x = np.full((G, DR, K), np.nan)
    ring_b = np.full((T, DB, K), np.nan)
    tag_r, tag_x, tag_b = (np.full(a.shape[:2], -1)
                           for a in (ring_r, ring_x, ring_b))
    n_out = len(structure.sink_groups)
    lat = np.full((-(-steps // sample_every), n_out, K), np.nan)
    for w in range(steps + skew * (TL - 1) if steps else 0):
        reads, writes = set(), set()     # ring entries this wave touches
        for row, (lo, hi) in enumerate(rows):
            t = w - skew * lag[row]
            if not 0 <= t < steps:
                continue
            at = t % DR
            rate = src[row]
            if edges[row]:
                rate = np.zeros(K)
                for s, mult in edges[row]:
                    reads.add(("r", s, at))
                    assert tag_r[s, at] == t
                    rate = rate + ring_r[s, at] * mult
            sample, per_task = t % sample_every == 0, np.zeros(K)
            if hi > lo:
                total = np.zeros(K)
                for g in range(lo, hi):
                    q_len = queue[g] + rate * frac[g] * dt
                    srv = np.minimum(q_len, capdt[g])
                    queue[g] = q_len - srv
                    total = total + srv
                    pos_cap, cap = caps[g] > 0, np.where(caps[g] > 0,
                                                         caps[g], 1.0)
                    if t >= s0:
                        acc[g] = acc[g] + srv
                        ring_x[pos[g], at] = np.where(pos_cap, srv / cap, 0.0)
                        tag_x[pos[g], at] = t
                    if sample:
                        per_task = np.where(
                            pos_cap, per_task + frac[g] * (queue[g] + 1.0)
                            / cap, per_task)
                rate = total / dt
            ring_r[row, at] = rate
            tag_r[row, at] = t
            writes.add(("r", row, at))
            if sample:
                n_at = (t // sample_every) % DB
                best = per_task
                if edges[row]:
                    up = np.full(K, -np.inf)
                    for j, (s, _) in enumerate(edges[row]):
                        reads.add(("b", s, n_at))
                        assert tag_b[s, n_at] == t // sample_every
                        up = np.maximum(up, ring_b[s, n_at]
                                        + hops[e_off[row] + j])
                    best = per_task + up
                ring_b[row, n_at] = best
                tag_b[row, n_at] = t // sample_every
                writes.add(("b", row, n_at))
        assert not reads & writes, f"wave {w} races on {reads & writes}"
        tb = w - skew * (TL - 1)
        if tb >= s0 and tb >= 0:
            for s in range(S):
                for i in range(s_off[s], s_off[s + 1]):
                    assert tag_x[i, tb % DR] == tb
                    bsy[s] = bsy[s] + ring_x[i, tb % DR]
        for i, sinks in enumerate(structure.sink_groups):
            t = w - skew * k_last[i]
            if 0 <= t < steps and t % sample_every == 0:
                n_at = (t // sample_every) % DB
                m = np.zeros(K)
                if sinks:
                    assert all(tag_b[r, n_at] == t // sample_every
                               for r in sinks)
                    m = ring_b[sinks[0], n_at]
                    for r in sinks[1:]:
                        m = np.maximum(m, ring_b[r, n_at])
                lat[t // sample_every, i] = m
    realized = ring_r[:, (steps - 1) % DR] if steps else np.zeros((T, K))
    return queue, bsy, acc, realized, lat


@pytest.mark.parametrize("size, skew", [(8, "launch"), (8, "sample_every"),
                                        (12, "launch"),
                                        (12, "sample_every")])
def test_wave_schedule_with_per_dag_lags_is_numpy_bit_for_bit(
        fleet_batches, size, skew):
    """The kernel's schedule on a stacked fleet, each DAG lagged from its
    own first row and the busy terms added once every DAG's deepest row has
    finished their tick, gives numpy's engine to the last bit; at the skew
    the launch takes, and at sample_every with the deeper rings."""
    batch, planned = fleet_batches[size]
    spec = batch.spec
    fracs = np.array([0.4, 0.9, 1.3])
    omegas = [fracs * w for w in planned]
    steps, every, s0 = port_sim._sweep_steps(8.0, 0.05, 2.0, 0.25)
    caps = np.concatenate([effective_capacity_matrix(s.gi, w)
                           for s, w in zip(batch.sims, omegas)])
    src = np.concatenate([s.gi.betas[:, None] * w[None, :]
                          for s, w in zip(batch.sims, omegas)])
    structure = pack_structure(spec.row_slices, spec.in_edges,
                               spec.sink_groups, len(spec.slots),
                               torch.device("cpu"))
    if skew == "launch":
        skew = _fleet_shape(batch, len(fracs), every,
                            lag_rows=structure.lag_rows)[1]
    else:
        skew = every
    assert steps > sweep_kernel.ring_depth(skew * 16 + 1)  # the rings wrap
    want = port_sim._sweep_numpy(spec, caps, src, steps, every, s0, 0.05)
    got = _wave_model(structure, caps, src, spec.g_frac, spec.g_slot,
                      batch._hops_flat, steps=steps, sample_every=every,
                      s0=s0, dt=0.05, skew=skew)
    for f, a, b in zip(RAW_FIELDS, got, want):
        assert a.shape == b.shape, f
        assert np.array_equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 24])
def test_cuda_kernel_runs_stacked_fleets(fleet_batches, size):
    """On the card: a stacked fleet batch in one launch within 1e-10 of the
    numpy engine, 8 DAGs with their state in shared memory and 24 with it
    laid out in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    batch, planned = fleet_batches[size]
    omegas = [np.array([0.25, 0.75, 1.0, 1.25]) * w for w in planned]
    kw = dict(duration=10.0, dt=0.05)
    want = batch.sweep_raw(omegas, engine="numpy", **kw)
    steps, every, _ = port_sim._sweep_steps(10.0, 0.05, 5.0, 0.25)
    where = _fleet_shape(batch, 4, every, lag_rows=17)[3]
    assert where == ("shared" if size == 8 else "device")
    before = sweep_kernel.launch_count()
    got = batch.sweep_raw(omegas, device="cuda", **kw)
    assert sweep_kernel.launch_count() == before + 1
    assert_raw_close(got, want)
