"""Simulation-guided mapper search: score a candidate-mapping pool on the
sweep engine, batched over candidate mappings.

The paper's §7 mappers (DSM/RSM/SAM) are picked by model intuition; the §11
study showed the *simulator* is what actually separates shuffle from
slot-aware behaviour.  This module closes the loop: generate many candidate
thread→slot mappings for ONE allocation, simulate every candidate's full
rate sweep, and rank them by their empirical max stable rate — the
candidate-pool-scored-by-throughput-estimate scheme of Nasiri et al. and
Shukla & Simmhan, run on the sweep kernel (one launch per shape bucket)
instead of one Python simulation per candidate.

Candidate pool
--------------
* the three §7 mappers (``MAPPERS``),
* RSM ``w_cpu``/``w_mem``/``w_net`` weight sweeps (each weighting is a
  different best-fit order, hence a different packing),
* seeded local moves from each base mapping — swap the contents of two used
  slots or migrate a task's thread bundle to an empty slot
  (:func:`repro_torch.core.mapping.local_moves`),

all on one shared VM pool so ranks compare like for like, deduplicated by
:func:`~repro_torch.core.mapping.mapping_signature` (co-location up to slot
renaming within a VM).

Shape-bucketed batched evaluation
---------------------------------
Candidates of one DAG share the task rows, the in-edge wiring, and the rate
grid; their sweep specs differ only in per-row *group* layout (how many
(task, slot) groups each task has), routing fractions, group→slot ids, and
hop latencies.  Local moves preserve group sizes exactly, so whole families
of candidates share one shape; the evaluator

1. pads each candidate's per-row group counts and slot count up to
   powers of two and buckets candidates by the padded shape (padded groups
   carry ``capacity = fraction = 0`` so they are exact no-ops; the kernel
   skips them, walking only each candidate's real groups per row),
2. stacks each bucket's per-candidate arrays (capacities, fractions, slot
   ids, hops, real groups per row) on a leading candidate axis, and
3. runs the whole bucket through ONE launch of the sweep kernel
   (:mod:`repro_torch.kernels.sweep_scan`) with a leading candidate axis,
   its structure packed once per bucket shape and device in the
   module-level cache (:func:`repro_torch.core.simulator.get_scan_kernel`);
   repeated searches are pure cache hits.

The engine keeps the reference's name, ``engine="vmap"``; ``device`` says
where it runs (``None``: CUDA, which raises without a GPU; ``"cpu"``: the
kernel's plain PyTorch version).  ``evaluate_candidates(engine="numpy")``
is the host reference path (one
:class:`~repro_torch.core.simulator.DataflowSimulator` numpy tick loop per
candidate) that the batched engine must match to <= 1e-10.

Entry points: :func:`search_mapping` (one DAG → :class:`RankedCandidates`)
and ``scheduler.plan(..., mapper="search")``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .allocation import ALLOCATORS, Allocation
from .dag import Dataflow
from .mapping import (DEFAULT_VM_SIZES, MAPPERS, InsufficientResourcesError,
                      Mapping as ThreadMapping, VM, acquire_vms, local_moves,
                      map_rsm, mapping_signature)
from .perfmodel import ModelLibrary
from .predictor import (GroupIndex, build_group_index,
                        effective_capacity_matrix, predict_max_rate_gi)
from .routing import RoutingPolicy
from ..obs.trace import trace as _obs_trace
from ..models.common import DeviceLike
from .simulator import (STABLE_SLOPE_PER_S, DataflowSimulator, SweepRaw,
                        _slope_columns, _sweep_steps, edge_hop_latencies,
                        get_scan_kernel, run_sweep_kernel)

#: Default RSM weight sweep: the plain R-Storm distance plus CPU-heavy,
#: memory-heavy, network-blind, and network-dominated orderings.
DEFAULT_RSM_WEIGHTS: Tuple[Tuple[float, float, float], ...] = (
    (2.0, 1.0, 1.0), (1.0, 2.0, 1.0), (1.0, 1.0, 0.0), (0.5, 0.5, 2.0))

EVAL_ENGINES = ("vmap", "numpy")

#: :func:`search_mapping` keywords the scheduler integration owns —
#: ``search_opts`` dicts passed through ``plan(mapper="search")`` may not
#: override these.
RESERVED_SEARCH_OPTS = frozenset(
    {"allocator", "allocation", "vms", "grow_pool", "vm_sizes"})


@dataclasses.dataclass
class Candidate:
    """One named candidate mapping (pre-evaluation)."""

    name: str
    mapping: ThreadMapping


@dataclasses.dataclass
class CandidateResult:
    """One candidate's simulated rate sweep, post-judgement."""

    name: str
    mapping: ThreadMapping
    omegas: np.ndarray            # (K,) swept DAG rates
    stable: np.ndarray            # (K,) per-rate stability verdicts
    latency_slope: np.ndarray     # (K,) s of latency per s of run time
    max_stable_rate: float        # largest swept rate judged stable
    predicted_max_rate: float     # §8.5 model prediction for comparison
    used_slots: int


@dataclasses.dataclass
class RankedCandidates:
    """Search result: candidates ranked best-first by simulated max stable
    rate (ties: fewer used slots, then name)."""

    dag: str
    omega: float
    allocator: str
    policy: RoutingPolicy
    omegas: np.ndarray
    vms: List[VM]
    engine: str
    candidates: List[CandidateResult]
    bucket_sizes: List[int]           # candidates per compiled shape bucket

    @property
    def best(self) -> CandidateResult:
        return self.candidates[0]

    def result_for(self, name: str) -> Optional[CandidateResult]:
        return next((c for c in self.candidates if c.name == name), None)

    def gain_over(self, name: str) -> Optional[float]:
        """Best max stable rate minus the named candidate's (None when the
        named candidate was infeasible on the shared pool)."""
        base = self.result_for(name)
        return None if base is None else \
            self.best.max_stable_rate - base.max_stable_rate

    def describe(self) -> str:
        lines = [f"MapperSearch[{self.dag}] omega={self.omega:g} "
                 f"policy={self.policy.value} {len(self.candidates)} "
                 f"candidates in {len(self.bucket_sizes)} shape buckets "
                 f"{self.bucket_sizes}"]
        for c in self.candidates:
            lines.append(f"  {c.name}: actual max {c.max_stable_rate:g} t/s "
                         f"(predicted {c.predicted_max_rate:.1f}, "
                         f"{c.used_slots} slots)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Candidate-pool generation.
# ---------------------------------------------------------------------------

def generate_candidates(dag: Dataflow, alloc: Allocation, vms: Sequence[VM],
                        models: ModelLibrary, *,
                        rsm_weights: Sequence[Tuple[float, float, float]]
                        = DEFAULT_RSM_WEIGHTS,
                        n_moves: int = 8, seed: int = 0,
                        include: Sequence[str] = ("dsm", "rsm", "sam"),
                        base_mappings: Optional[Dict[str, ThreadMapping]]
                        = None,
                        extra_mappings: Optional[Dict[str, ThreadMapping]]
                        = None) -> List[Candidate]:
    """The candidate pool for one (allocation, VM pool): base mappers, RSM
    weight variants, and ``n_moves`` seeded local moves per base candidate,
    deduplicated by co-location signature.  Mappers that cannot pack the
    pool are skipped (DSM always fits, so the pool is never empty).
    ``base_mappings`` reuses prebuilt mappings for this exact (alloc, vms)
    — e.g. the pool-growth probes of :func:`search_mapping` — instead of
    re-running those mappers.  ``extra_mappings`` (name -> mapping) are
    caller-supplied candidates — e.g. the online controller's *incumbent*
    mapping as a warm start — added to the pool and, like every base, used
    to seed local moves."""
    out: List[Candidate] = []
    seen = set()

    def add(name: str, mapping: ThreadMapping) -> None:
        sig = mapping_signature(mapping)
        if sig not in seen:
            seen.add(sig)
            out.append(Candidate(name, mapping))

    for name, mapping in (extra_mappings or {}).items():
        add(name, mapping)
    for name in include:
        if base_mappings is not None and name in base_mappings:
            add(name, base_mappings[name])
            continue
        try:
            add(name, MAPPERS[name](dag, alloc, vms, models))
        except InsufficientResourcesError:
            continue
    if "rsm" in include:
        for wc, wm, wn in rsm_weights:
            try:
                add(f"rsm[{wc:g},{wm:g},{wn:g}]",
                    map_rsm(dag, alloc, vms, models,
                            w_cpu=wc, w_mem=wm, w_net=wn))
            except InsufficientResourcesError:
                continue
    for b, base in enumerate(list(out)):
        # per-base seed offset is positional, not hash(name): str hash is
        # randomized per process and would break seeded reproducibility
        for k, moved in enumerate(local_moves(
                base.mapping, n_moves=n_moves, seed=seed + 97 * b)):
            add(f"{base.name}+move{k}", moved)
    return out


# ---------------------------------------------------------------------------
# Shape-bucketed batched evaluation.
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _hops_flat(gi: GroupIndex) -> np.ndarray:
    parts = [np.asarray(h, dtype=float) for h in edge_hop_latencies(gi)]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=float)


def evaluate_candidates(dag: Dataflow, alloc: Allocation,
                        mappings: Sequence[ThreadMapping],
                        models: ModelLibrary,
                        omegas: Sequence[float], *,
                        policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
                        cpu_penalty: bool = True,
                        duration: float = 10.0, dt: float = 0.1,
                        warmup: float = 2.5,
                        latency_sample_every: float = 0.25,
                        engine: str = "vmap",
                        gis: Optional[Sequence[GroupIndex]] = None,
                        bucket_sizes: Optional[List[int]] = None,
                        device: DeviceLike = None) -> List[SweepRaw]:
    """Simulate every candidate mapping's rate sweep; one :class:`SweepRaw`
    per candidate, in input order.

    ``engine="vmap"`` pads the candidates into shape buckets and runs each
    bucket through one launch of the sweep kernel on ``device`` (see the
    module docstring); ``engine="numpy"`` is the per-candidate reference
    tick loop the batched path must match to <= 1e-10.  ``gis`` (optional)
    reuses prebuilt :class:`GroupIndex` per mapping; ``bucket_sizes``
    (optional, output) is filled with the number of candidates per bucket.
    """
    if engine not in EVAL_ENGINES:
        raise ValueError(f"unknown candidate-evaluation engine {engine!r}")
    omegas = np.asarray(omegas, dtype=float)
    if engine == "numpy":
        out = []
        for m in mappings:
            sim = DataflowSimulator(dag, alloc, m, models, policy=policy,
                                    cpu_penalty=cpu_penalty)
            out.append(sim.sweep_raw(
                omegas, duration=duration, dt=dt, warmup=warmup,
                latency_sample_every=latency_sample_every, engine="numpy"))
        if bucket_sizes is not None:
            bucket_sizes[:] = [1] * len(mappings)
        return out

    if gis is None:
        gis = [build_group_index(dag, alloc, m, models, policy)
               for m in mappings]
    if not gis:
        return []
    steps, sample_every, s0 = _sweep_steps(duration, dt, warmup,
                                           latency_sample_every)
    K = len(omegas)
    gi0 = gis[0]
    src_rate = gi0.betas[:, None] * omegas[None, :]     # shared: same DAG
    in_edges = gi0.in_edges
    sink_rows = [gi0.task_of[t.name] for t in dag.sinks()]
    sample_times = np.arange(0, steps, sample_every) * dt
    window = max(steps - s0, 1) * dt

    buckets: Dict[Tuple, List[int]] = {}
    for i, gi in enumerate(gis):
        counts = tuple(hi - lo for lo, hi in gi.row_slices())
        pad_counts = tuple(_next_pow2(c) if c else 0 for c in counts)
        key = (pad_counts, _next_pow2(len(gi.slots)))
        buckets.setdefault(key, []).append(i)

    raws: List[Optional[SweepRaw]] = [None] * len(gis)
    if bucket_sizes is not None:
        bucket_sizes[:] = [len(v) for v in buckets.values()]
    for (pad_counts, s_pad), idxs in buckets.items():
        offs = np.concatenate([[0], np.cumsum(pad_counts)]).astype(int)
        row_slices = [(int(offs[r]), int(offs[r + 1]))
                      for r in range(len(pad_counts))]
        g_pad = int(offs[-1])
        C = len(idxs)
        caps_b = np.zeros((C, g_pad, K))
        frac_b = np.zeros((C, g_pad))
        slot_b = np.zeros((C, g_pad), dtype=np.int32)
        hops_b = np.zeros((C, sum(len(e) for e in in_edges)))
        counts_b = np.zeros((C, len(pad_counts)), dtype=np.int32)
        real_idx: List[np.ndarray] = []
        for j, i in enumerate(idxs):
            gi = gis[i]
            caps = effective_capacity_matrix(gi, omegas,
                                             cpu_penalty=cpu_penalty)
            dsts = []
            for r, (lo, hi) in enumerate(gi.row_slices()):
                dst = offs[r] + np.arange(hi - lo)
                dsts.append(dst)
                caps_b[j, dst, :] = caps[lo:hi]
                frac_b[j, dst] = gi.g_frac[lo:hi]
                slot_b[j, dst] = gi.g_slot[lo:hi]
                counts_b[j, r] = hi - lo
            real_idx.append(np.concatenate(dsts).astype(int) if dsts
                            else np.zeros(0, dtype=int))
            hops_b[j] = _hops_flat(gi)
        structure = get_scan_kernel(row_slices, in_edges, [sink_rows], s_pad,
                                    device=device)
        q, busy, srv, realized, lat = run_sweep_kernel(
            structure, caps_b, src_rate, frac_b, slot_b, hops_b, counts_b,
            steps=steps, sample_every=sample_every, s0=s0, dt=dt)
        for j, i in enumerate(idxs):
            ri = real_idx[j]
            n_slots = len(gis[i].slots)
            raws[i] = SweepRaw(
                queues=q[j][ri], busy=busy[j][:n_slots], served=srv[j][ri],
                realized=realized[j], latency=lat[j],
                sample_times=sample_times, steps=steps, s0=s0, dt=dt,
                window=window)
    return raws  # type: ignore[return-value]


def _judge_raw(raw: SweepRaw) -> Tuple[np.ndarray, np.ndarray]:
    """(stable, slopes) per swept rate — the §5.1 latency-slope criterion,
    identical to ``SweepBatch.results_from_raw`` (post-warmup tail, whole
    series when fewer than 3 post-warmup samples exist)."""
    times = raw.sample_times
    warm_time = raw.s0 * raw.dt
    k0 = (int(np.argmax(times >= warm_time - 1e-12))
          if np.any(times >= warm_time - 1e-12) else 0)
    if len(times) - k0 < 3:
        k0 = 0
    interval = (times[1] - times[0]) if len(times) > 1 else 1.0
    slopes = _slope_columns(raw.latency[k0:, 0, :]) / interval
    return slopes <= STABLE_SLOPE_PER_S, slopes


# ---------------------------------------------------------------------------
# The search.
# ---------------------------------------------------------------------------

@_obs_trace("search_mapping")
def search_mapping(dag: Dataflow, omega: float, models: ModelLibrary, *,
                   allocator: str = "mba",
                   allocation: Optional[Allocation] = None,
                   policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
                   cpu_penalty: bool = True,
                   rate_fractions: Optional[Sequence[float]] = None,
                   duration: float = 10.0, dt: float = 0.1,
                   warmup: float = 2.5, latency_sample_every: float = 0.25,
                   rsm_weights: Sequence[Tuple[float, float, float]]
                   = DEFAULT_RSM_WEIGHTS,
                   n_moves: int = 8, seed: int = 0,
                   vms: Optional[Sequence[VM]] = None,
                   vm_sizes: Sequence[int] = DEFAULT_VM_SIZES,
                   grow_pool: bool = True, max_extra_slots: int = 8,
                   include: Sequence[str] = ("dsm", "rsm", "sam"),
                   extra_candidates: Optional[Dict[str, ThreadMapping]]
                   = None,
                   engine: str = "vmap",
                   device: DeviceLike = None) -> RankedCandidates:
    """Simulation-guided mapping for ``dag`` at rate ``omega``: build the
    candidate pool, co-evaluate every candidate's rate sweep
    (``omega * rate_fractions``, default 0.5..1.5) on the batched sweep
    engine (on ``device``; ``None``: CUDA), and rank by empirical max
    stable rate.

    ``vms`` pins the pool (a fixed cluster); otherwise §7.1
    acquisition (``vm_sizes``) for the allocation's estimate, grown one
    slot at a time (bounded by ``max_extra_slots``) until every base mapper
    in ``include`` packs it — all candidates then compete on the same
    hardware.  ``allocation`` skips re-allocating when the caller already
    has one.

    ``extra_candidates`` (name -> mapping) warm-starts the pool with
    caller-supplied mappings — the online controller passes the incumbent
    schedule's mapping so a replan can only beat it, never regress — each
    validated to map exactly this allocation's threads onto the search
    pool's VMs, then deduped and move-seeded like any base candidate.
    """
    alloc = allocation if allocation is not None \
        else ALLOCATORS[allocator](dag, omega, models)
    pool = list(vms) if vms is not None else acquire_vms(alloc.slots,
                                                         vm_sizes)
    base_maps: Dict[str, ThreadMapping] = {}

    def map_bases() -> bool:
        """Run every base mapper on the current pool, keeping the successes
        for candidate generation; True when all of ``include`` fit."""
        base_maps.clear()
        ok = True
        for name in include:
            try:
                base_maps[name] = MAPPERS[name](dag, alloc, pool, models)
            except InsufficientResourcesError:
                ok = False
        return ok

    fits = map_bases()
    if grow_pool:
        for extra in range(max_extra_slots):
            if fits:
                break
            if vms is not None:
                pool = pool + [VM(max(v.id for v in pool) + 1, 1)]
            else:
                pool = acquire_vms(alloc.slots + extra + 1, vm_sizes)
            fits = map_bases()
    if extra_candidates:
        from .mapping import make_threads
        pool_ids = {vm.id for vm in pool}
        want = set(make_threads(alloc))
        for name, m in extra_candidates.items():
            if set(m.assignment) != want:
                raise ValueError(
                    f"extra candidate {name!r} does not map this "
                    "allocation's thread set")
            if any(s.vm not in pool_ids for s in m.assignment.values()):
                raise ValueError(
                    f"extra candidate {name!r} uses VMs outside the "
                    "search pool")
    cands = generate_candidates(dag, alloc, pool, models,
                                rsm_weights=rsm_weights, n_moves=n_moves,
                                seed=seed, include=include,
                                base_mappings=base_maps,
                                extra_mappings=extra_candidates)
    if not cands:
        raise InsufficientResourcesError(
            "<pool>", "no candidate mapping packs the search pool")
    fracs = np.asarray(rate_fractions, dtype=float) \
        if rate_fractions is not None else np.linspace(0.5, 1.5, 11)
    omegas = omega * fracs
    gis = [build_group_index(dag, alloc, c.mapping, models, policy)
           for c in cands]
    bucket_sizes: List[int] = []
    raws = evaluate_candidates(
        dag, alloc, [c.mapping for c in cands], models, omegas,
        policy=policy, cpu_penalty=cpu_penalty, duration=duration, dt=dt,
        warmup=warmup, latency_sample_every=latency_sample_every,
        engine=engine, gis=gis, bucket_sizes=bucket_sizes, device=device)
    results: List[CandidateResult] = []
    for cand, gi, raw in zip(cands, gis, raws):
        stable, slopes = _judge_raw(raw)
        ok = omegas[stable]
        results.append(CandidateResult(
            name=cand.name, mapping=cand.mapping, omegas=omegas,
            stable=stable, latency_slope=slopes,
            max_stable_rate=float(ok.max()) if ok.size else 0.0,
            predicted_max_rate=float(predict_max_rate_gi(gi)),
            used_slots=len(gi.slots)))
    results.sort(key=lambda c: (-c.max_stable_rate, c.used_slots, c.name))
    return RankedCandidates(
        dag=dag.name, omega=float(omega), allocator=allocator, policy=policy,
        omegas=omegas, vms=pool, engine=engine, candidates=results,
        bucket_sizes=bucket_sizes)
