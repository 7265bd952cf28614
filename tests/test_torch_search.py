"""The port's simulation-guided mapper search against the reference's.

The port's batched engine (``engine="vmap"``: one launch of the sweep
kernel per power-of-two shape bucket, here on ``device="cpu"``, i.e. the
kernel's plain PyTorch version) and its ``numpy`` engine must reproduce the
reference's per-candidate ``engine="numpy"`` surfaces to 1e-10 (the
tolerance of ``repro/core/search.py``), on a pool spanning several shape
buckets, under both routing policies.  ``search_mapping`` and
``plan(mapper="search")`` must pick the reference's winner, in the
reference's rank order, with the buckets the reference's vmapped engine
forms (``search.py:281-290``, recomputed here from the reference's own
group indices: its ``vmap`` engine itself needs
``jax.experimental.enable_x64``, which the installed JAX lacks).

The plain version given each candidate's real groups per row must equal
the plain version walking every padded group, on a padded bucket of each
DAG's search: the kernel's skip of the padding is exact.

The ``cuda`` tests hold the kernel's candidate batches, and the buckets at
the shapes that stress its warp-per-column design, against the plain
version; they run on the card with ``--noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core import search as ref_search
from repro_torch import obs
from repro_torch.core import search as port_search
from repro_torch.core import simulator as port_sim
from repro_torch.core.mapping import make_threads
from repro_torch.kernels.sweep_scan import kernel as sweep_kernel
from repro_torch.kernels.sweep_scan import ops as sweep_ops
from repro_torch.kernels.sweep_scan.ref import (full_counts, live_groups,
                                                pack_structure,
                                                sweep_scan_reference)

RAW_FIELDS = ("queues", "busy", "served", "realized", "latency")
POLICIES = [p.value for p in port.RoutingPolicy]
TINY = dict(duration=4.0, dt=0.1)
SMALL_SEARCH = dict(n_moves=2, rate_fractions=[0.8, 1.0, 1.2], **TINY)
TOL = 1e-10


@pytest.fixture(scope="module")
def libs():
    return port.paper_library(), ref.paper_library()


@pytest.fixture(scope="module")
def buckets(libs):
    """Per DAG, the arguments of every bucket its search launches (4 s at
    dt 0.1, the window from tick 25, on the CPU): ((structure, caps,
    src_rate, g_frac, g_slot, hops, counts), tick keywords)."""
    calls, original = [], port_search.run_sweep_kernel

    def record(*args, **kw):
        calls.append((args, kw))
        return original(*args, **kw)

    out = {}
    port_search.run_sweep_kernel = record
    try:
        for dag in sorted(port.ALL_DAGS):
            calls.clear()
            port.search_mapping(port.ALL_DAGS[dag](), 100, libs[0],
                                device="cpu", **TINY)
            out[dag] = list(calls)
    finally:
        port_search.run_sweep_kernel = original
    return out


def bucket_tensors(args, device):
    """A recorded bucket as the sweep engine's tensors on ``device``: the
    inputs in call order, then the structure."""
    structure, caps, src, frac, slot, hops, counts = args
    f64, i32 = torch.float64, torch.int32
    tensors = [torch.as_tensor(np.ascontiguousarray(a), dtype=t,
                               device=device)
               for a, t in ((caps, f64), (src, f64), (frac, f64),
                            (slot, i32), (hops, f64), (counts, i32))]
    return tensors, pack_structure(structure.row_slices, structure.in_edges,
                                   structure.sink_groups, structure.n_slots,
                                   device)


def most_padded(calls):
    """The recorded bucket with the most padded groups."""
    def padding(call):
        structure, caps, *_, counts = call[0]
        return caps.shape[0] * structure.n_groups - int(counts.sum())
    return max(calls, key=padding)


@pytest.fixture(scope="module")
def pools(libs):
    """The diamond DAG's candidate pool in both packages, on one VM pool."""
    lib, jlib = libs
    out = {}
    for name, pkg, search, lb, kw in (
            ("port", port, port_search, lib, dict(device="cpu")),
            ("ref", ref, ref_search, jlib, dict(engine="numpy"))):
        dag = pkg.ALL_DAGS["diamond"]()
        alloc = pkg.ALLOCATORS["mba"](dag, 100, lb)
        ranked = search.search_mapping(dag, 100, lb, n_moves=2,
                                       rate_fractions=[1.0], duration=1.0,
                                       dt=0.5, **kw)
        cands = search.generate_candidates(dag, alloc, ranked.vms, lb,
                                           n_moves=2)
        out[name] = (dag, alloc, ranked.vms, cands)
    return out


def reference_buckets(gis):
    """Candidates per bucket as the reference's vmapped engine forms them."""
    buckets = {}
    for i, gi in enumerate(gis):
        counts = tuple(hi - lo for lo, hi in gi.row_slices())
        key = (tuple(ref_search._next_pow2(c) if c else 0 for c in counts),
               ref_search._next_pow2(len(gi.slots)))
        buckets.setdefault(key, []).append(i)
    return [len(v) for v in buckets.values()]


def _ref_pool_gis(ranked, dag, alloc, jlib):
    """Group indices of the reference search's pool, in pool order (the
    order its buckets are formed in, not the rank order)."""
    cands = ref_search.generate_candidates(dag, alloc, ranked.vms, jlib)
    assert sorted(c.name for c in cands) == \
        sorted(c.name for c in ranked.candidates)
    return [ref.build_group_index(dag, alloc, c.mapping, jlib, ranked.policy)
            for c in cands]


def test_candidate_pools_equal(pools):
    (_, _, vms, cands), (_, _, jvms, jcands) = pools["port"], pools["ref"]
    assert [(v.id, v.num_slots) for v in vms] == \
        [(v.id, v.num_slots) for v in jvms]
    assert [c.name for c in cands] == [c.name for c in jcands]
    for a, b in zip(cands, jcands):
        assert sorted((repr(t), s.vm, s.slot)
                      for t, s in a.mapping.assignment.items()) == \
            sorted((repr(t), s.vm, s.slot)
                   for t, s in b.mapping.assignment.items())


@pytest.mark.parametrize("engine", list(port_search.EVAL_ENGINES))
@pytest.mark.parametrize("policy", POLICIES)
def test_evaluate_candidates_matches_reference_numpy(libs, pools, policy,
                                                     engine):
    """>= 3 candidates over several shape buckets: every raw surface of
    every candidate within 1e-10 of the reference's per-candidate numpy
    run; the batched engine forms the reference's buckets."""
    lib, jlib = libs
    dag, alloc, _, cands = pools["port"]
    jdag, jalloc, _, jcands = pools["ref"]
    omegas = np.linspace(60.0, 140.0, 5)
    sizes = []
    got = port_search.evaluate_candidates(
        dag, alloc, [c.mapping for c in cands], lib, omegas,
        policy=port.RoutingPolicy(policy), engine=engine, bucket_sizes=sizes,
        device="cpu", **TINY)
    want = ref_search.evaluate_candidates(
        jdag, jalloc, [c.mapping for c in jcands], jlib, omegas,
        policy=ref.RoutingPolicy(policy), engine="numpy", **TINY)
    assert len(cands) >= 3 and len(got) == len(want) == len(cands)
    if engine == "vmap":
        gis = [ref.build_group_index(jdag, jalloc, c.mapping, jlib,
                                     ref.RoutingPolicy(policy))
               for c in jcands]
        assert sizes == reference_buckets(gis)
        assert len(sizes) >= 2
    else:
        assert sizes == [1] * len(cands)
    for a, b in zip(got, want):
        for f in RAW_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.shape == y.shape, f
            if x.size:
                np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL,
                                           err_msg=f)
        np.testing.assert_array_equal(a.sample_times, b.sample_times)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dag", sorted(port.ALL_DAGS))
def test_search_mapping_matches_reference(libs, dag, policy):
    """The default search (11 rates, 10 s at dt 0.1): same pool, winner,
    rank order, verdicts and buckets as the reference's numpy search."""
    lib, jlib = libs
    ours = port.search_mapping(port.ALL_DAGS[dag](), 100, lib,
                               policy=port.RoutingPolicy(policy),
                               device="cpu")
    jdag = ref.ALL_DAGS[dag]()
    theirs = ref_search.search_mapping(jdag, 100, jlib,
                                       policy=ref.RoutingPolicy(policy),
                                       engine="numpy")
    assert ours.best.name == theirs.best.name
    assert [c.name for c in ours.candidates] == \
        [c.name for c in theirs.candidates]
    for a, b in zip(ours.candidates, theirs.candidates):
        assert a.max_stable_rate == b.max_stable_rate
        assert a.predicted_max_rate == b.predicted_max_rate
        np.testing.assert_array_equal(a.stable, b.stable)
        np.testing.assert_allclose(a.latency_slope, b.latency_slope,
                                   rtol=TOL, atol=TOL)
    alloc = ref.ALLOCATORS["mba"](jdag, 100, jlib)
    assert ours.bucket_sizes == reference_buckets(
        _ref_pool_gis(theirs, jdag, alloc, jlib))
    np.testing.assert_array_equal(ours.omegas, theirs.omegas)


@pytest.mark.parametrize("omega", [50.0, 100.0])
@pytest.mark.parametrize("dag", ["traffic", "finance", "grid"])
def test_plan_mapper_search_matches_reference(libs, dag, omega):
    lib, jlib = libs
    ours = port.plan(port.ALL_DAGS[dag](), omega, lib, mapper="search",
                     search_opts=dict(device="cpu", **SMALL_SEARCH))
    theirs = ref.plan(ref.ALL_DAGS[dag](), omega, jlib, mapper="search",
                      search_opts=dict(engine="numpy", **SMALL_SEARCH))
    assert ours.mapper == "search"
    assert ours.search_winner == theirs.search_winner
    assert [(v.id, v.num_slots) for v in ours.vms] == \
        [(v.id, v.num_slots) for v in theirs.vms]
    assert sorted((repr(t), s.vm, s.slot)
                  for t, s in ours.mapping.assignment.items()) == \
        sorted((repr(t), s.vm, s.slot)
               for t, s in theirs.mapping.assignment.items())
    assert (ours.estimated_slots, ours.acquired_slots) == \
        (theirs.estimated_slots, theirs.acquired_slots)
    assert set(ours.mapping.assignment) == set(make_threads(ours.allocation))


@pytest.mark.parametrize("key", sorted(port_search.RESERVED_SEARCH_OPTS))
def test_reserved_search_opts_raise(libs, key):
    with pytest.raises(ValueError, match="may not override"):
        port.plan(port.ALL_DAGS["linear"](), 100, libs[0], mapper="search",
                  search_opts={key: None, "device": "cpu"})


def test_extra_candidates_warm_start(libs, pools):
    """An incumbent joins the pool under its own name and the search result
    is never worse than it."""
    lib, _ = libs
    dag, alloc, vms, _ = pools["port"]
    incumbent = port.MAPPERS["sam"](dag, alloc, vms, lib)
    ranked = port.search_mapping(
        dag, 100, lib, allocation=alloc, vms=vms, grow_pool=False,
        n_moves=0, rate_fractions=[0.8, 1.2], duration=1.0, dt=0.5,
        extra_candidates={"incumbent": incumbent}, device="cpu")
    inc = ranked.result_for("incumbent")
    assert inc is not None
    assert ranked.gain_over("incumbent") >= 0


def test_extra_candidates_validation(libs, pools):
    """Extras that map another thread set, or sit on VMs outside the search
    pool, are rejected up front."""
    lib, _ = libs
    dag, alloc, vms, _ = pools["port"]
    kw = dict(allocation=alloc, vms=vms, grow_pool=False, n_moves=0,
              rate_fractions=[1.0], duration=1.0, dt=0.5, device="cpu")
    half = port.ALLOCATORS["mba"](dag, 50, lib)
    with pytest.raises(ValueError, match="thread set"):
        port.search_mapping(dag, 100, lib, extra_candidates={
            "bad": port.MAPPERS["dsm"](dag, half, vms, lib)}, **kw)
    foreign = [port.VM(900 + i, vm.num_slots) for i, vm in enumerate(vms)]
    with pytest.raises(ValueError, match="outside the search pool"):
        port.search_mapping(dag, 100, lib, extra_candidates={
            "bad": port.MAPPERS["dsm"](dag, alloc, foreign, lib)}, **kw)


def test_second_evaluation_is_a_pure_cache_hit(libs, pools):
    lib, _ = libs
    dag, alloc, _, cands = pools["port"]
    maps = [c.mapping for c in cands]
    omegas = np.linspace(60.0, 140.0, 5)
    sizes = []
    port_search.evaluate_candidates(dag, alloc, maps, lib, omegas,
                                    device="cpu", bucket_sizes=sizes, **TINY)
    before = port_sim.scan_kernel_cache_stats()
    port_search.evaluate_candidates(dag, alloc, maps, lib, omegas,
                                    device="cpu", **TINY)
    after = port_sim.scan_kernel_cache_stats()
    assert after["hits"] == before["hits"] + len(sizes)
    assert after["misses"] == before["misses"]
    assert after["compiled"] == before["compiled"]


def test_plan_and_search_are_traced(libs):
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    try:
        port.plan(port.ALL_DAGS["linear"](), 100, libs[0], mapper="search",
                  search_opts=dict(device="cpu", **SMALL_SEARCH))
    finally:
        obs.set_tracer(prev)
    by_name = {s.name: s for s in tracer.spans}
    assert by_name["plan"].depth == 0
    assert by_name["search_mapping"].depth == 1


def test_search_without_cuda_raises_by_default(libs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lib, _ = libs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.plan(port.ALL_DAGS["linear"](), 100, lib, mapper="search",
                  search_opts=SMALL_SEARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.search_mapping(port.ALL_DAGS["linear"](), 100, lib,
                            **SMALL_SEARCH)
    # the host engine needs no device
    assert port.search_mapping(port.ALL_DAGS["linear"](), 100, lib,
                               engine="numpy", **SMALL_SEARCH).candidates
    with pytest.raises(ValueError, match="unknown candidate-evaluation"):
        port.search_mapping(port.ALL_DAGS["linear"](), 100, lib,
                            engine="scan", **SMALL_SEARCH)


@pytest.mark.parametrize("dag", sorted(port.ALL_DAGS))
def test_plain_version_skips_padding_exactly(buckets, dag):
    """On the DAG's most padded bucket: the plain version given each
    candidate's real groups per row equals it walking every padded group
    (cap = frac = 0), bit for bit, and ignores what the padding holds."""
    args, kw = most_padded(buckets[dag])
    tensors, structure = bucket_tensors(args, torch.device("cpu"))
    counts = tensors[5]
    full = full_counts(structure, counts.shape[0])
    assert bool((counts < full).any()) and kw["s0"] < kw["steps"]
    skip = sweep_scan_reference(*tensors, structure, **kw)
    walk = sweep_scan_reference(*tensors[:5], full, structure, **kw)
    live = live_groups(structure, counts)
    noisy = list(tensors)
    noisy[0] = torch.where(live[:, :, None], noisy[0], 3.0)
    noisy[2] = torch.where(live, noisy[2], 0.25)
    assert not torch.equal(noisy[0], tensors[0])
    for f, a, b, c in zip(RAW_FIELDS, skip, walk,
                          sweep_scan_reference(*noisy, structure, **kw)):
        assert torch.equal(a, b), f
        assert torch.equal(a, c), f


def edge_case(buckets, case):
    """(bucket arguments, tick keywords) of one stress shape of the
    warp-per-column kernel, and a check that the bucket has that shape."""
    if case == "rows_over_a_warp":     # grid at 100 t/s, rows padded to 64
        args, kw = max(buckets["grid"], key=lambda c: c[0][1].shape[1])
        assert int(args[6].max()) > 32
    elif case == "slot_of_several_rows":
        args, kw = buckets["diamond"][0]
        structure, slot, counts = args[0], args[4], args[6]
        rows = {}
        for r, (lo, hi) in enumerate(structure.row_slices):
            for g in range(lo, lo + int(counts[0, r])):
                rows.setdefault(int(slot[0, g]), set()).add(r)
        assert max(len(v) for v in rows.values()) > 1
    elif case == "k_not_a_multiple_of_warps":
        args, kw = buckets["finance"][0]
        assert args[1].shape[2] % sweep_kernel.MAX_WARPS != 0
    elif case == "padded_candidates":
        args, kw = most_padded(buckets["traffic"])
        structure, counts = args[0], args[6]
        assert counts.shape[0] > 1 and int(counts.sum()) < \
            counts.shape[0] * structure.n_groups
    elif case == "sample_every_1":
        args, kw = buckets["traffic"][0]
        kw = dict(kw, sample_every=1)
    elif case == "samples_off_the_wave":   # rings too deep for skew 5
        args, kw = max(buckets["grid"], key=lambda c: c[0][1].shape[1])
        kw = dict(kw, sample_every=5)
        structure, caps, counts = args[0], args[1], args[6]
        assert sweep_kernel.launch_shape(
            structure.n_groups, structure.n_slots, structure.n_rows,
            structure.n_edges, structure.n_out, len(structure.sink_rows),
            int(counts.sum(axis=1).max()), caps.shape[2], 5)[1] == 1
    else:                               # "s0_past_steps"
        args, kw = buckets["star"][0]
        kw = dict(kw, s0=kw["steps"] + 3)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "rows_over_a_warp", "slot_of_several_rows", "k_not_a_multiple_of_warps",
    "padded_candidates", "sample_every_1", "samples_off_the_wave",
    "s0_past_steps"])
def test_cuda_kernel_matches_plain_at_stress_shapes(buckets, case):
    """One launch at each stress shape, every field within 1e-10 of the
    plain version on the same card tensors; the padding holds garbage the
    kernel must skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    args, kw = edge_case(buckets, case)
    tensors, structure = bucket_tensors(args, torch.device("cuda"))
    live = live_groups(structure, tensors[5])
    tensors[0] = torch.where(live[:, :, None], tensors[0], 3.0)
    tensors[2] = torch.where(live, tensors[2], 0.25)
    before = sweep_kernel.launch_count()
    got = sweep_ops.sweep_scan(*tensors, structure, **kw)
    torch.cuda.synchronize()
    assert sweep_kernel.launch_count() == before + 1
    want = sweep_scan_reference(*tensors, structure, **kw)
    for f, x, y in zip(RAW_FIELDS, got, want):
        assert x.shape == y.shape, f
        torch.testing.assert_close(x, y, rtol=TOL, atol=TOL, msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("dag", ["traffic", "finance", "grid"])
def test_cuda_search_matches_plain(libs, dag):
    """On the card: one kernel launch per bucket, the same ranking as the
    plain version, and every candidate's surfaces within 1e-10 of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    lib, _ = libs
    before = sweep_kernel.launch_count()
    ours = port.search_mapping(port.ALL_DAGS[dag](), 100, lib)
    assert sweep_kernel.launch_count() - before == len(ours.bucket_sizes)
    plain = port.search_mapping(port.ALL_DAGS[dag](), 100, lib, device="cpu")
    assert [c.name for c in ours.candidates] == \
        [c.name for c in plain.candidates]
    assert ours.bucket_sizes == plain.bucket_sizes
    for a, b in zip(ours.candidates, plain.candidates):
        assert a.max_stable_rate == b.max_stable_rate
        np.testing.assert_allclose(a.latency_slope, b.latency_slope,
                                   rtol=TOL, atol=TOL)
