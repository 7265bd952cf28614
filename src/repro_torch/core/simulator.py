"""Discrete-time (fluid) simulation of a scheduled dataflow.

Stands in for the paper's live Apache Storm runs: tuple streams flow through
the mapped DAG, each (task, slot) group services at the model capacity
``I_t(q)`` (degraded by the §8.4.2 CPU-oversubscription penalty), routing
follows shuffle or slot-aware policy, queues accumulate when a group is
overloaded, and the stability test is the paper's latency-slope criterion
(the slope is measured in seconds of latency per second of run time, so the
verdict does not depend on ``latency_sample_every``).

The simulator is what the benchmark harness calls the *actual* behaviour.  It
deliberately contains effects the schedule planner does NOT model (routing
skew, oversubscription throttling, network hops), which is what produces the
planned-vs-actual gaps reported in Figs. 7–13.  Hop latency between two
tasks is the *flow-weighted* expectation over their (src group, dst group)
pairs — each pair weighted by the source group's routed fraction times the
destination group's routing fraction — so shuffle and slot-aware routing see
different expected hops for the same mapping.

Engines
-------
Internally the engine is fully vectorized: per-group queues and capacities
live in flat arrays keyed by a precomputed :class:`GroupIndex`, with the
*rate sweep* as a trailing array axis.  Two interchangeable engines advance
the ``(G, K)`` state:

``engine="scan"``    the default: the whole tick loop in one launch of the
                     hand-written CUDA kernel of
                     :mod:`repro_torch.kernels.sweep_scan` on the card, or
                     its plain PyTorch version with ``device="cpu"``.  The
                     per-row gather/scatter structure (contiguous group
                     slices, in-edge sources and multipliers, sink rows) is
                     precomputed from the :class:`GroupIndex` into a
                     :class:`_SweepSpec` and packed on the device once per
                     structure; float64, matching numpy to ~1e-12.
``engine="numpy"``   the reference tick loop on the host: Python over ticks
                     and rows, numpy over the ``(., K)`` columns.

``device`` (on :class:`DataflowSimulator`, :meth:`SweepBatch.sweep_raw` and
:meth:`SweepBatch.simulate`) says where the scan engine runs: ``None`` is
CUDA, which raises on a machine without a GPU; ``"cpu"`` runs the plain
version.  There is no fallback from one to the other.

``simulate_sweep(omegas)`` runs a whole vector of input rates through one
time loop; ``run(omega)`` is the single-column special case, and
``max_stable_rate`` refines the stability boundary with multi-point sweep
passes instead of one-rate-at-a-time bisection.  :class:`SweepBatch`
co-simulates *several* independently scheduled dataflows in ONE time loop
over the union of their slot pools — busy time lands on shared slots
additively (the shared-VM-pool semantics of fleet co-simulation).

Packed structures are cached at module level keyed by the spec's
*structural* signature and the device (:func:`get_scan_kernel`): placement
data (capacities, routing fractions, slot ids, hop latencies) is passed to
the kernel as arrays, not baked, so every batch, ``max_stable_rate`` pass
and mapper-search run with the same structure reuses one packed structure
— including the candidate-batched form the simulation-guided search
(:mod:`repro_torch.core.search`) evaluates whole candidate pools with.  One
built kernel serves every structure.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .allocation import Allocation
from .dag import Dataflow
from .mapping import Mapping as ThreadMapping, SlotId
from .perfmodel import ModelLibrary
from .predictor import (GroupIndex, build_group_index, effective_capacities,
                        effective_capacity_matrix, slot_groups)
from .routing import RoutingPolicy, group_rates
from ..kernels.sweep_scan import kernel as _sweep_kernel
from ..kernels.sweep_scan import ops as _sweep_ops
from ..kernels.sweep_scan.ref import SweepStructure, pack_structure
from ..models.common import DeviceLike, resolve_device
from ..obs import metrics as _obs_metrics
from ..obs.trace import span as _obs_span

#: Network hop latencies (s): same slot / same VM / cross VM.
HOP_SAME_SLOT = 0.0002
HOP_SAME_VM = 0.001
HOP_CROSS_VM = 0.005

#: §5.1 stability criterion: a run is stable when the fitted latency slope
#: does not exceed this, in seconds of latency per second of run time.
STABLE_SLOPE_PER_S = 1e-3

ENGINES = ("numpy", "scan")

#: Module-level cache of packed sweep structures
#: (:class:`~repro_torch.kernels.sweep_scan.ref.SweepStructure`), keyed by
#: the *structural* signature of a :class:`_SweepSpec` (row slices, in-edge
#: wiring, sink rows, slot count — everything shape-like) and the device
#: they live on.  Placement data (capacities, routing fractions, slot ids,
#: hop latencies) is passed to the kernel as arrays, so two specs that
#: differ only in where threads sit share ONE packed structure, and one
#: built kernel library serves every structure.  Repeated searches,
#: ``max_stable_rate`` passes and fleet replans therefore pack nothing anew.
_KERNEL_CACHE: Dict[tuple, SweepStructure] = {}
_KERNEL_STATS = {"hits": 0, "misses": 0}
#: Guards both dicts above: searches and fleet replans may request kernels
#: from worker threads, and an unlocked check-then-insert would double-pack
#: the same structure and tear the hit/miss counters.
_KERNEL_LOCK = threading.Lock()


def scan_kernel_cache_stats() -> Dict[str, int]:
    """Hit/miss counters of the module-level structure cache, plus
    ``compiled``: the sweep kernel libraries built and loaded in this
    process (1 after the first sweep on the card, 0 on the CPU), so a delta
    of zero between two runs proves nothing was rebuilt."""
    with _KERNEL_LOCK:
        entries = len(_KERNEL_CACHE)
        stats = dict(_KERNEL_STATS)
    return {"entries": entries, "hits": stats["hits"],
            "misses": stats["misses"], "compiled": _sweep_kernel.built()}


def scan_kernel_cache_clear() -> None:
    with _KERNEL_LOCK:
        _KERNEL_CACHE.clear()
        _KERNEL_STATS["hits"] = _KERNEL_STATS["misses"] = 0


def _kernel_cache_collector(registry: "_obs_metrics.MetricsRegistry") -> None:
    """Pull-style obs bridge: publish cache stats at snapshot time."""
    stats = scan_kernel_cache_stats()
    registry.gauge("repro_scan_kernel_cache_entries",
                   "Distinct sweep structures packed and cached."
                   ).set(stats["entries"])
    registry.gauge("repro_scan_kernel_cache_hits_total",
                   "Sweep-structure cache lookups served from cache."
                   ).set(stats["hits"])
    registry.gauge("repro_scan_kernel_cache_misses_total",
                   "Sweep-structure cache lookups that packed."
                   ).set(stats["misses"])
    lookups = stats["hits"] + stats["misses"]
    registry.gauge("repro_scan_kernel_cache_hit_ratio",
                   "hits / (hits + misses) of the sweep-structure cache."
                   ).set(stats["hits"] / lookups if lookups else 0.0)


_obs_metrics.register_collector(_kernel_cache_collector)


def _kernel_key(row_slices, in_edges, sink_groups, n_slots: int) -> tuple:
    return (int(n_slots),
            tuple((int(lo), int(hi)) for lo, hi in row_slices),
            tuple(tuple((int(s), float(m)) for s, m in e) for e in in_edges),
            tuple(tuple(int(r) for r in rows) for rows in sink_groups))


def get_scan_kernel(row_slices, in_edges, sink_groups, n_slots: int,
                    *, device: DeviceLike = None) -> SweepStructure:
    """The packed sweep structure for one spec structure on ``device``
    (``None``: CUDA), from the module cache.  The reference keys its
    vmapped kernel apart from the single one; here one kernel serves both
    uses, so a sweep and a search of the same structure share one entry."""
    dev = resolve_device(device)
    key = _kernel_key(row_slices, in_edges, sink_groups, n_slots) + (str(dev),)
    with _KERNEL_LOCK:
        structure = _KERNEL_CACHE.get(key)
        if structure is None:
            _KERNEL_STATS["misses"] += 1
            with _obs_span("scan_kernel_compile", slots=int(n_slots)):
                structure = pack_structure(row_slices, in_edges, sink_groups,
                                           n_slots, dev)
            _KERNEL_CACHE[key] = structure
        else:
            _KERNEL_STATS["hits"] += 1
    return structure


def run_sweep_kernel(structure: SweepStructure, caps: np.ndarray,
                     src_rate: np.ndarray, g_frac: np.ndarray,
                     g_slot: np.ndarray, hops: np.ndarray, *, steps: int,
                     sample_every: int, s0: int, dt: float
                     ) -> Tuple[np.ndarray, ...]:
    """One launch of the sweep engine on the structure's device: caps (C, G,
    K), src_rate (T, K), g_frac/g_slot (C, G) and hops (C, E) cross over
    as numpy arrays and (queues, busy, served, realized, latency) come back
    as numpy arrays with the leading candidate axis."""
    dev = structure.row_off.device

    def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    out = _sweep_ops.sweep_scan(
        put(caps, torch.float64), put(src_rate, torch.float64),
        put(g_frac, torch.float64), put(g_slot, torch.int32),
        put(hops, torch.float64), structure, steps=steps,
        sample_every=sample_every, s0=s0, dt=dt)
    return tuple(t.cpu().numpy() for t in out)


def _sweep_steps(duration: float, dt: float, warmup: float,
                 latency_sample_every: float) -> Tuple[int, int, int]:
    """(steps, sample_every, s0) — the shared discretization of a sweep.

    The measurement window starts at the first tick at or past ``warmup``;
    runs too short to have one fall back to the whole run (mirroring the
    latency tail-window fallback in ``results_from_raw``)."""
    steps = int(duration / dt)
    sample_every = max(1, int(latency_sample_every / dt))
    s0 = int(np.ceil(warmup / dt - 1e-9))
    if s0 >= steps or s0 < 0:
        s0 = 0
    return steps, sample_every, s0


@dataclasses.dataclass
class SimResult:
    omega: float
    stable: bool
    latency_slope: float           # seconds of latency per second of run time
    mean_latency: float            # end-to-end seconds (stable portion)
    p99_latency: float
    latency_samples: List[float]
    queue_total: float             # final total queued tuples
    #: per slot, the time-averaged SUM of its groups' thread utilizations —
    #: a slot hosting several saturated groups reads above 1.0
    slot_busy: Dict[SlotId, float]


@dataclasses.dataclass
class SweepRaw:
    """Raw engine output for one sweep (shared by both engines).

    ``latency`` holds the path latency at every sample tick per *output
    group* (one per co-simulated dataflow, in :class:`SweepBatch` order);
    ``busy``/``served`` are accumulated only over the measured window
    (post-warmup ticks) of ``window`` seconds.
    """

    queues: np.ndarray        # (G, K) final queue length per group
    busy: np.ndarray          # (S, K) busy-seconds within the window
    served: np.ndarray        # (G, K) tuples served within the window
    realized: np.ndarray      # (T, K) final-tick realized output rates
    latency: np.ndarray       # (n_samples, n_out, K)
    sample_times: np.ndarray  # (n_samples,)
    steps: int                # ticks simulated (realized horizon steps * dt)
    s0: int                   # first tick counted into busy/served
    dt: float                 # tick length (s)
    window: float             # (steps - s0) * dt seconds


@dataclasses.dataclass
class _SweepSpec:
    """Precomputed gather/scatter index arrays for the tick kernels.

    Flattens one or more :class:`GroupIndex` instances (tasks stacked in topo
    order, groups contiguous per task, slots deduplicated across dataflows)
    so both engines' step bodies are pure array ops over the ``(G, K)``
    state.
    """

    row_slices: List[Tuple[int, int]]          # (T,) group span per task row
    in_edges: List[List[Tuple[int, float]]]    # (T,) (src row, multiplier)
    hops: List[List[float]]                    # (T,) hop latency per in-edge
    g_frac: np.ndarray                         # (G,) routing fraction
    g_slot: np.ndarray                         # (G,) union slot row
    g_task: np.ndarray                         # (G,) owning task row
    slots: List[SlotId]                        # (S,) union slot pool
    sink_groups: List[List[int]]               # per output: sink task rows

    @property
    def n_rows(self) -> int:
        return len(self.row_slices)

    @property
    def n_groups(self) -> int:
        return len(self.g_frac)


def _hop_latency(gi, src_row: int, dst_row: int) -> float:
    """Expected network hop latency between two tasks' thread groups,
    weighted by the tuple flow each (src group, dst group) pair actually
    carries: the source group's routed fraction times the destination
    group's routing fraction (both rate-independent under either policy).

    An unweighted average would count a 9-thread destination group the
    same as a 2-thread one; with flow weights, shuffle and slot-aware
    routing see different expected hop latencies for the same mapping.
    """
    sl_s, sl_d = gi.task_slice(src_row), gi.task_slice(dst_row)
    if sl_s.start == sl_s.stop or sl_d.start == sl_d.stop:
        return 0.0
    w = gi.g_frac[sl_s, None] * gi.g_frac[None, sl_d]
    vm_s = np.array([gi.slots[s].vm for s in gi.g_slot[sl_s]])
    vm_d = np.array([gi.slots[s].vm for s in gi.g_slot[sl_d]])
    hop = np.where(gi.g_slot[sl_s, None] == gi.g_slot[None, sl_d],
                   HOP_SAME_SLOT,
                   np.where(vm_s[:, None] == vm_d[None, :],
                            HOP_SAME_VM, HOP_CROSS_VM))
    total_w = w.sum()
    if total_w <= 0:        # degenerate zero-fraction groups: fall back
        return float(hop.mean())
    return float((w * hop).sum() / total_w)


def edge_hop_latencies(gi) -> List[List[float]]:
    """Per task row, hop latency of each in-edge (rate-independent) for a
    prebuilt :class:`~repro_torch.core.predictor.GroupIndex` — shared by the
    simulator and the mapper-search candidate evaluator."""
    return [[_hop_latency(gi, src, row) for src, _ in gi.in_edges[row]]
            for row in range(len(gi.tasks))]


class DataflowSimulator:
    """Fluid-flow simulation with per-group queues at dt resolution.

    ``device`` is where the ``"scan"`` engine runs (``None``: CUDA, which
    raises without a GPU; ``"cpu"``: the plain version); the ``"numpy"``
    engine runs on the host whatever it says."""

    def __init__(self, dag: Dataflow, alloc: Allocation,
                 mapping: ThreadMapping, models: ModelLibrary,
                 *, policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
                 cpu_penalty: bool = True, seed: int = 0,
                 engine: str = "scan", gi: Optional[GroupIndex] = None,
                 device: DeviceLike = None):
        if engine not in ENGINES:
            raise ValueError(f"unknown simulator engine {engine!r}")
        self.dag = dag
        self.alloc = alloc
        self.mapping = mapping
        self.models = models
        self.policy = policy
        self.cpu_penalty = cpu_penalty
        self.engine = engine
        self.device = device
        self.groups = slot_groups(mapping, alloc)
        self.rng = random.Random(seed)
        # ``gi`` reuses a prebuilt index for exactly (dag, alloc, mapping,
        # policy) — e.g. the one a FleetEntry already carries — so repeated
        # co-simulations of a live fleet (the online controller's
        # between-events loop) skip the flattening pass entirely
        self.gi = gi if gi is not None \
            else build_group_index(dag, alloc, mapping, models, policy)
        self._hops = edge_hop_latencies(self.gi)
        self._sink_rows = [self.gi.task_of[t.name] for t in dag.sinks()]
        self._batch: Optional[SweepBatch] = None

    # -- main entry ------------------------------------------------------------
    def run(self, omega: float, *, duration: float = 60.0, dt: float = 0.05,
            warmup: float = 5.0, latency_sample_every: float = 0.25,
            engine: Optional[str] = None) -> SimResult:
        return self.simulate_sweep(
            [omega], duration=duration, dt=dt, warmup=warmup,
            latency_sample_every=latency_sample_every, engine=engine)[0]

    def simulate_sweep(self, omegas: Sequence[float], *,
                       duration: float = 60.0, dt: float = 0.05,
                       warmup: float = 5.0,
                       latency_sample_every: float = 0.25,
                       engine: Optional[str] = None) -> List[SimResult]:
        """Simulate every input rate in ``omegas`` through ONE time loop.

        All per-group state is a ``(G, K)`` array (groups x rates); each tick
        advances the whole sweep at once.  Results match per-rate ``run``
        calls (``run`` *is* the K=1 column of this loop).  ``engine``
        overrides the instance default (``"numpy"`` or ``"scan"``).
        """
        if self._batch is None:
            self._batch = SweepBatch([self])
        return self._batch.simulate(
            [omegas], duration=duration, dt=dt, warmup=warmup,
            latency_sample_every=latency_sample_every,
            engine=engine or self.engine, device=self.device)[0]

    def sweep_raw(self, omegas: Sequence[float], *,
                  duration: float = 60.0, dt: float = 0.05,
                  warmup: float = 5.0, latency_sample_every: float = 0.25,
                  engine: Optional[str] = None) -> SweepRaw:
        """The raw engine state for a sweep (queues, busy, served, realized,
        latency series) — the engine-equivalence contract surface."""
        if self._batch is None:
            self._batch = SweepBatch([self])
        return self._batch.sweep_raw(
            [omegas], duration=duration, dt=dt, warmup=warmup,
            latency_sample_every=latency_sample_every,
            engine=engine or self.engine, device=self.device)

    # -- derived measurements ---------------------------------------------------
    def max_stable_rate(self, *, lo: float = 1.0, hi: float = 1e5,
                        tol: float = 0.01, duration: float = 30.0,
                        dt: float = 0.05, probes: int = 8,
                        engine: Optional[str] = None) -> float:
        """Highest stable DAG rate (the paper's empirical 'actual rate':
        increase until the latency slope turns positive).

        Each refinement pass sweeps ``probes`` interior rates through one
        vectorized ``simulate_sweep`` call, shrinking the bracket by
        ``probes + 1`` per pass — the sweep-engine replacement for
        one-rate-at-a-time bisection.  Every pass reuses the same sweep
        shape, so the ``"scan"`` engine packs its structure once.
        """
        # quick analytic bracket from capacities
        from .predictor import predict_max_rate
        analytic = predict_max_rate(self.dag, self.alloc, self.mapping,
                                    self.models, self.policy)
        hi = min(hi, analytic * 1.5 + 10)
        lo_ok, hi_bad = 0.0, hi
        while hi_bad - lo_ok > tol * max(1.0, lo_ok):
            mids = np.linspace(lo_ok, hi_bad, probes + 2)[1:-1]
            stable = [r.stable for r in self.simulate_sweep(
                mids, duration=duration, dt=dt, engine=engine)]
            n_ok = next((i for i, s in enumerate(stable) if not s),
                        len(stable))
            if n_ok > 0:
                lo_ok = float(mids[n_ok - 1])
            if n_ok < len(mids):
                hi_bad = float(mids[n_ok])
            # every probe stable: lo_ok moved to mids[-1], so the bracket
            # still shrank by (probes+1) and the loop converges toward hi
        return lo_ok


# ---------------------------------------------------------------------------
# Co-simulation of one or more dataflows through one time loop.
# ---------------------------------------------------------------------------

class SweepBatch:
    """Co-simulate several scheduled dataflows' rate sweeps in ONE time loop.

    The simulators' :class:`GroupIndex` structures are flattened into one
    :class:`_SweepSpec` (task rows stacked, groups contiguous, slot pools
    deduplicated by :class:`SlotId`), so a fleet of independent DAGs advances
    as a single ``(G_total, K)`` array pass per tick — and, under
    ``engine="scan"``, as a single launch of the sweep kernel.  Slots
    shared between dataflows accumulate busy time from all of them (the
    shared-VM-pool semantics fleet co-simulation relies on); each per-DAG
    :class:`SimResult` reports the slots its own mapping uses.
    """

    def __init__(self, sims: Sequence[DataflowSimulator]):
        if not sims:
            raise ValueError("SweepBatch needs at least one simulator")
        self.sims = list(sims)
        self._build_spec()
        parts = [np.asarray(h, dtype=float) for h in self.spec.hops]
        self._hops_flat = (np.concatenate(parts) if parts
                           else np.zeros(0, dtype=float))

    def _build_spec(self) -> None:
        row_slices: List[Tuple[int, int]] = []
        in_edges: List[List[Tuple[int, float]]] = []
        hops: List[List[float]] = []
        g_frac: List[float] = []
        g_slot: List[int] = []
        g_task: List[int] = []
        slots: List[SlotId] = []
        slot_of: Dict[SlotId, int] = {}
        sink_groups: List[List[int]] = []
        self.row_spans: List[Tuple[int, int]] = []
        self.group_spans: List[Tuple[int, int]] = []
        self._sim_slot_rows: List[np.ndarray] = []
        row_off = grp_off = 0
        for sim in self.sims:
            gi = sim.gi
            for lo, hi in gi.row_slices():
                row_slices.append((lo + grp_off, hi + grp_off))
            for row in range(len(gi.tasks)):
                in_edges.append([(src + row_off, mult)
                                 for src, mult in gi.in_edges[row]])
                hops.append(list(sim._hops[row]))
            sim_rows = []
            for s in gi.slots:
                if s not in slot_of:
                    slot_of[s] = len(slots)
                    slots.append(s)
                sim_rows.append(slot_of[s])
            self._sim_slot_rows.append(np.asarray(sim_rows, dtype=int))
            remap = np.asarray(sim_rows, dtype=int)
            g_slot.extend((remap[gi.g_slot]).tolist() if gi.n_groups else [])
            g_task.extend((gi.g_task + row_off).tolist())
            g_frac.extend(gi.g_frac.tolist())
            sink_groups.append([r + row_off for r in sim._sink_rows])
            self.row_spans.append((row_off, row_off + len(gi.tasks)))
            self.group_spans.append((grp_off, grp_off + gi.n_groups))
            row_off += len(gi.tasks)
            grp_off += gi.n_groups
        self.spec = _SweepSpec(
            row_slices=row_slices, in_edges=in_edges, hops=hops,
            g_frac=np.asarray(g_frac, dtype=float),
            g_slot=np.asarray(g_slot, dtype=int),
            g_task=np.asarray(g_task, dtype=int),
            slots=slots, sink_groups=sink_groups)

    # -- raw engine dispatch --------------------------------------------------
    def sweep_raw(self, omegas_list: Sequence[Sequence[float]], *,
                  duration: float = 60.0, dt: float = 0.05,
                  warmup: float = 5.0, latency_sample_every: float = 0.25,
                  engine: str = "scan", device: DeviceLike = None) -> SweepRaw:
        """The raw engine state of one co-simulated sweep.  ``device`` is
        where the ``"scan"`` engine runs (``None``: CUDA)."""
        if engine not in ENGINES:
            raise ValueError(f"unknown simulator engine {engine!r}")
        if len(omegas_list) != len(self.sims):
            raise ValueError("one omega vector per co-simulated dataflow")
        omegas = [np.asarray(w, dtype=float) for w in omegas_list]
        K = len(omegas[0])
        if any(len(w) != K for w in omegas):
            raise ValueError("all sweeps must share one rate-grid length")
        caps = np.concatenate([
            effective_capacity_matrix(sim.gi, w, cpu_penalty=sim.cpu_penalty)
            for sim, w in zip(self.sims, omegas)], axis=0)
        src_rate = np.concatenate([
            sim.gi.betas[:, None] * w[None, :]
            for sim, w in zip(self.sims, omegas)], axis=0)
        steps, sample_every, s0 = _sweep_steps(duration, dt, warmup,
                                               latency_sample_every)
        if engine == "scan":
            queues, busy, served, realized, lat = self._run_scan(
                caps, src_rate, steps, sample_every, s0, dt, device)
        else:
            queues, busy, served, realized, lat = _sweep_numpy(
                self.spec, caps, src_rate, steps, sample_every, s0, dt)
        sample_times = np.arange(0, steps, sample_every) * dt
        return SweepRaw(queues=queues, busy=busy, served=served,
                        realized=realized, latency=lat,
                        sample_times=sample_times, steps=steps, s0=s0,
                        dt=dt, window=max(steps - s0, 1) * dt)

    def simulate(self, omegas_list: Sequence[Sequence[float]], *,
                 duration: float = 60.0, dt: float = 0.05,
                 warmup: float = 5.0, latency_sample_every: float = 0.25,
                 engine: str = "scan", device: DeviceLike = None
                 ) -> List[List[SimResult]]:
        """Per-simulator lists of :class:`SimResult`, one per swept rate."""
        omegas = [np.asarray(w, dtype=float) for w in omegas_list]
        raw = self.sweep_raw(omegas, duration=duration, dt=dt, warmup=warmup,
                             latency_sample_every=latency_sample_every,
                             engine=engine, device=device)
        return self.results_from_raw(omegas, raw)

    def results_from_raw(self, omegas_list: Sequence[np.ndarray],
                         raw: SweepRaw) -> List[List[SimResult]]:
        """Post-process one :class:`SweepRaw` into per-simulator results
        (split out of :meth:`simulate` so callers that also need the raw
        state — e.g. fleet resource studies — run the engine once).  The
        warm-up cut is derived from the window baked into ``raw`` (its
        ``s0``), so latency stats and busy fractions share one notion of
        warm-up — they only diverge in the explicit short-run fallback
        below, where too few post-warmup samples exist for a slope fit and
        the whole latency series is judged instead."""
        omegas = [np.asarray(w, dtype=float) for w in omegas_list]
        # stability: slope of latencies past warm-up (§5.1 criterion).  The
        # short-run path is explicit: with fewer than 3 post-warmup samples a
        # slope fit is meaningless, so the WHOLE series (warmup included) is
        # judged — and ``latency_samples`` reports exactly the judged window.
        times = raw.sample_times
        warm_time = raw.s0 * raw.dt
        k0 = (int(np.argmax(times >= warm_time - 1e-12))
              if np.any(times >= warm_time - 1e-12) else 0)
        if len(times) - k0 < 3:
            k0 = 0
        interval = (times[1] - times[0]) if len(times) > 1 else 1.0
        out: List[List[SimResult]] = []
        for i, sim in enumerate(self.sims):
            g_lo, g_hi = self.group_spans[i]
            tail = raw.latency[k0:, i, :]
            # per-sample slope -> seconds of latency per second of run time
            slopes = _slope_columns(tail) / interval
            slot_rows = self._sim_slot_rows[i]
            results: List[SimResult] = []
            for k in range(tail.shape[1]):
                col = tail[:, k]
                mean_lat = float(col.mean()) if col.size else 0.0
                p99 = float(np.sort(col)[int(0.99 * (col.size - 1))]) \
                    if col.size else 0.0
                results.append(SimResult(
                    omega=float(omegas[i][k]),
                    stable=bool(slopes[k] <= STABLE_SLOPE_PER_S),
                    latency_slope=float(slopes[k]), mean_latency=mean_lat,
                    p99_latency=p99, latency_samples=col.tolist(),
                    queue_total=float(raw.queues[g_lo:g_hi, k].sum()),
                    slot_busy={sim.gi.slots[j]:
                               float(raw.busy[s, k] / raw.window)
                               for j, s in enumerate(slot_rows)},
                ))
            out.append(results)
        return out

    # -- the sweep kernel ---------------------------------------------------
    def _run_scan(self, caps: np.ndarray, src_rate: np.ndarray, steps: int,
                  sample_every: int, s0: int, dt: float, device: DeviceLike):
        spec = self.spec
        structure = get_scan_kernel(spec.row_slices, spec.in_edges,
                                    spec.sink_groups, len(spec.slots),
                                    device=device)
        out = run_sweep_kernel(structure, caps[None], src_rate,
                               spec.g_frac[None], spec.g_slot[None],
                               self._hops_flat[None], steps=steps,
                               sample_every=sample_every, s0=s0, dt=dt)
        return tuple(a[0] for a in out)


# ---------------------------------------------------------------------------
# Engines.
# ---------------------------------------------------------------------------

def _sweep_numpy(spec: _SweepSpec, caps: np.ndarray, src_rate: np.ndarray,
                 steps: int, sample_every: int, s0: int, dt: float):
    """Reference tick loop: Python over ticks/rows, numpy over ``(., K)``."""
    T, G = spec.n_rows, spec.n_groups
    S = len(spec.slots)
    K = caps.shape[1]
    cap_pos = caps > 0
    safe_caps = np.where(cap_pos, caps, 1.0)
    queues = np.zeros((G, K))
    busy = np.zeros((S, K))
    served_acc = np.zeros((G, K))
    realized = np.zeros((T, K))
    served = np.zeros((G, K))
    lat: List[np.ndarray] = []
    for step in range(steps):
        # per-task realized output rate this tick, in topo order
        # (upstream being overloaded throttles downstream arrivals)
        for row in range(T):
            edges = spec.in_edges[row]
            if not edges:
                in_rate = src_rate[row]
            else:
                in_rate = np.zeros(K)
                for src, mult in edges:
                    in_rate = in_rate + realized[src] * mult
            lo, hi = spec.row_slices[row]
            if lo == hi:
                realized[row] = in_rate
                continue
            arr = in_rate[None, :] * spec.g_frac[lo:hi, None]
            q_len = queues[lo:hi] + arr * dt
            served[lo:hi] = np.minimum(q_len, caps[lo:hi] * dt)
            queues[lo:hi] = q_len - served[lo:hi]
            realized[row] = served[lo:hi].sum(axis=0) / dt
        if step >= s0:
            np.add.at(busy, spec.g_slot,
                      np.where(cap_pos, served / safe_caps, 0.0))
            served_acc += served
        if step % sample_every == 0:
            lat.append(_path_latency_np(spec, queues, caps))
    n_out = len(spec.sink_groups)
    lat_arr = (np.stack(lat) if lat else np.zeros((0, n_out, K)))
    return queues, busy, served_acc, realized, lat_arr


def _path_latency_np(spec: _SweepSpec, queues: np.ndarray,
                     caps: np.ndarray) -> np.ndarray:
    """Expected end-to-end latency per sweep column and output group: per
    task, the routing-weighted queue wait + service time, plus hop latency
    along the longest (source -> sink) DAG path."""
    K = queues.shape[1]
    contrib = np.where(caps > 0,
                       spec.g_frac[:, None] * (queues + 1.0)
                       / np.where(caps > 0, caps, 1.0),
                       0.0)
    per_task = np.zeros((spec.n_rows, K))
    np.add.at(per_task, spec.g_task, contrib)
    best = np.zeros_like(per_task)
    for row in range(spec.n_rows):
        edges = spec.in_edges[row]
        if not edges:
            best[row] = per_task[row]
            continue
        up = np.full(K, -np.inf)
        for (src, _), hop in zip(edges, spec.hops[row]):
            up = np.maximum(up, best[src] + hop)
        best[row] = per_task[row] + up
    out = np.zeros((len(spec.sink_groups), K))
    for i, rows in enumerate(spec.sink_groups):
        if rows:
            out[i] = np.max(best[rows], axis=0)
    return out


def _slope_columns(samples: np.ndarray) -> np.ndarray:
    """Least-squares slope of each column vs sample index (vectorized
    :func:`latency_slope`) — per *sample*; divide by the sample interval to
    get the per-second slope the stability criterion uses."""
    n = samples.shape[0]
    if n < 2:
        return np.zeros(samples.shape[1] if samples.ndim == 2 else 1)
    x = np.arange(n) - (n - 1) / 2.0
    den = float((x ** 2).sum())
    return x @ (samples - samples.mean(axis=0)) / den


def measured_resources(dag: Dataflow, alloc: Allocation, mapping: ThreadMapping,
                       models: ModelLibrary, omega: float,
                       policy: RoutingPolicy = RoutingPolicy.SHUFFLE,
                       *, seed: int = 0, noise: float = 0.06
                       ) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Per-VM 'actual' CPU%/mem% at rate omega.

    The actual usage differs from the §8.5 prediction because (a) routing
    skew sends groups more/less than their share — captured here by the
    fluid routing fractions — and (b) real resource draw is noisy; a small
    multiplicative noise term models the measurement scatter of Figs. 11-12.
    """
    rng = random.Random(seed)
    rates = dag.get_rates(omega)
    groups = slot_groups(mapping, alloc)
    caps = effective_capacities(dag, alloc, mapping, models)
    vm_cpu: Dict[int, float] = {vm.id: 0.0 for vm in mapping.vms}
    vm_mem: Dict[int, float] = {vm.id: 0.0 for vm in mapping.vms}
    for task, g in groups.items():
        kind = alloc.tasks[task].kind
        model = models[kind]
        incoming = group_rates(task, kind, rates[task], g, models, policy)
        for slot, q in g.items():
            cap = caps[task][slot]
            served = min(incoming[slot], cap)
            peak = model.I(q)
            frac_used = 1.0 if peak <= 0 else min(1.0, served / peak)
            jit_c = 1.0 + rng.uniform(-noise, noise)
            jit_m = 1.0 + rng.uniform(-noise, noise)
            vm_cpu[slot.vm] += model.C(q) * frac_used * jit_c
            vm_mem[slot.vm] += model.M(q) * frac_used * jit_m
    return vm_cpu, vm_mem
