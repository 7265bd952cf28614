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
from repro_torch.kernels.sweep_scan.ref import (pack_structure,
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
            ((1, 1), torch.int32), ((1, 0), torch.float64)))
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


def test_plain_version_rejects_out_of_range_slots():
    s = pack_structure([(0, 1)], [[]], [[0]], 1, torch.device("cpu"))
    f64 = dict(dtype=torch.float64)
    with pytest.raises(ValueError, match="slot outside"):
        sweep_scan_reference(torch.ones((1, 1, 2), **f64),
                             torch.ones((1, 2), **f64),
                             torch.ones((1, 1), **f64),
                             torch.full((1, 1), 3, dtype=torch.int32),
                             torch.zeros((1, 0), **f64), s, steps=2,
                             sample_every=1, s0=0, dt=0.1)


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
               for a, t in args]
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
