"""Vectorized batch planning engine (rate sweeps in one array pass).

The §8.5 protocol and every capacity-planning question of the paper reduce to
evaluating the allocators over a *vector* of candidate input rates: "what does
the DAG need at 10, 20, ..., 10000 t/s?".  The scalar allocators
(:mod:`repro_torch.core.allocation`) answer one rate per call with Python
loops; this module answers a whole sweep at once with numpy array passes over
the vectorized :class:`~repro_torch.core.perfmodel.PerfModel` accessors.

A copy of the JAX package's ``core/batch.py`` (numpy only); nothing but the
module references differs.

Task input rates are linear in the DAG rate (``rate_t = beta_t * Omega``, §6),
so a (tasks x rates) matrix of thread counts / CPU% / memory% falls out of a
single interpolation per task.  ``batch_slots`` is the feasibility oracle the
scheduler's bisection drives; ``batch_feasible`` evaluates a fleet of DAGs
against a budget in one call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np

from .allocation import UnsupportableRateError
from .dag import Dataflow
from .perfmodel import ModelLibrary


@dataclasses.dataclass
class BatchAllocation:
    """Allocations for one DAG over a vector of input rates.

    All arrays have shape ``(n_tasks, n_rates)``; row order is the DAG's
    topological order (``task_names``).
    """

    dag: str
    algorithm: str
    omegas: np.ndarray          # (K,) DAG input rates
    task_names: List[str]       # (T,)
    rates: np.ndarray           # (T, K) per-task input rates
    threads: np.ndarray         # (T, K) integer thread counts
    cpu: np.ndarray             # (T, K) estimated CPU% (slot units)
    mem: np.ndarray             # (T, K) estimated memory% (slot units)

    @property
    def total_cpu(self) -> np.ndarray:
        return self.cpu.sum(axis=0)

    @property
    def total_mem(self) -> np.ndarray:
        return self.mem.sum(axis=0)

    @property
    def total_threads(self) -> np.ndarray:
        return self.threads.sum(axis=0)

    @property
    def slots(self) -> np.ndarray:
        """rho per rate — ``max(ceil(sum cpu), ceil(sum mem), 1)``, exactly
        the scalar :attr:`Allocation.slots` rule.  Unsupportable rates
        (``clip_unsupportable``) carry infinite CPU/mem, and near-degenerate
        profiles can demand astronomically many slots; both are clamped to
        2**62 (exactly float64-representable) before the integer cast, so
        they never wrap negative and no real budget ever fits them."""
        return self.slots_for()

    def slots_for(self, mem_per_slot: float = 1.0) -> np.ndarray:
        """:attr:`slots` on a VM class whose slots hold ``mem_per_slot``
        memory quanta each: the memory term shrinks by that factor while
        the CPU term (one core per slot) is unchanged."""
        rho = np.maximum(np.ceil(self.total_cpu - 1e-9),
                         np.ceil(self.total_mem / mem_per_slot - 1e-9))
        rho = np.clip(rho, 1, 2.0 ** 62)
        return np.where(np.isnan(rho), 2.0 ** 62, rho).astype(np.int64)


def _to_threads(tau: np.ndarray) -> np.ndarray:
    """Integer thread counts without wrap-around: near-degenerate profiles
    (tiny ``omega_bar``/``omega_hat``) can demand more threads than int64
    holds; clamp at 2**62 before the cast."""
    return np.minimum(tau, 2.0 ** 62).astype(np.int64)


def _clip_or_raise(task: str, w: np.ndarray, bad: np.ndarray, clip: bool,
                   tau: np.ndarray, cpu: np.ndarray, mem: np.ndarray):
    """Shared unsupportable-rate handling: raise the typed error (the scalar
    allocators' behaviour) or, for planners sweeping past a DAG's ceiling,
    mark the offending columns infinitely expensive so the feasibility
    oracle reports them as not fitting any budget."""
    if not np.any(bad):
        return tau, cpu, mem
    if not clip:
        raise UnsupportableRateError(task, float(w[bad][0]))
    return (np.where(bad, 0, tau).astype(np.int64),
            np.where(bad, np.inf, cpu), np.where(bad, np.inf, mem))


def _lsa_task(model, w: np.ndarray, task: str, clip: bool):
    """Vectorized Alg. 2 inner loop: one thread per ``omega_bar`` of rate,
    trailing fraction scaled down proportionally."""
    w_bar = model.omega_bar
    c1, m1 = model.C(1), model.M(1)
    if w_bar <= 0:
        # degenerate profile: a single thread supports no rate at all, so
        # every positive rate is unsupportable (the scalar allocator's
        # UnsupportableRateError path).
        z = np.zeros_like(w)
        return _clip_or_raise(task, w, w > 1e-12, clip,
                              z.astype(int), z.copy(), z.copy())
    full = np.floor(w / w_bar)
    resid = w - full * w_bar
    has_resid = resid > 1e-12
    tau = _to_threads(full + has_resid)
    frac = np.where(has_resid, resid / w_bar, 0.0)
    return tau, c1 * (full + frac), m1 * (full + frac)


def _mba_task(model, w: np.ndarray, task: str, clip: bool):
    """Vectorized Alg. 3 inner loop: full ``tau_hat`` bundles at ``omega_hat``
    charging a whole slot each; the residual gets the smallest adequate
    thread count with model-interpolated resources."""
    w_hat = model.omega_hat
    tau_hat = model.tau_hat
    if w_hat <= 0:
        # degenerate profile: no bundles; any positive rate is a residual,
        # which T_many flags as unsupportable below (same error the scalar
        # allocator raises via T()).
        bundles = np.zeros_like(w)
        resid = w
    else:
        bundles = np.floor(w / w_hat)
        resid = w - bundles * w_hat
    has_resid = resid > 1e-12
    tau_p = np.where(has_resid, model.T_many(resid), 0)
    bad = tau_p < 0
    tau_p = np.where(bad, 0, tau_p)
    one = tau_p == 1
    many = tau_p > 1
    # tau_p == 1 implies I(1) >= resid > 0; guard the discarded branch anyway
    # so degenerate zero-rate profiles don't warn on the clip path
    i1 = model.I(1)
    safe_i1 = i1 if i1 > 0 else 1.0
    cpu = bundles + np.where(many, model.C(tau_p), 0.0) \
        + np.where(one, model.C(1) * resid / safe_i1, 0.0)
    mem = bundles + np.where(many, model.M(tau_p), 0.0) \
        + np.where(one, model.M(1) * resid / safe_i1, 0.0)
    return _clip_or_raise(task, w, bad, clip,
                          _to_threads(bundles * tau_hat + tau_p), cpu, mem)


_BATCH_ALLOCATORS: Dict[str, Callable] = {"lsa": _lsa_task, "mba": _mba_task}


def batch_allocate(dag: Dataflow, omegas: Sequence[float],
                   models: ModelLibrary, algorithm: str = "mba",
                   *, clip_unsupportable: bool = False,
                   speed: float = 1.0) -> BatchAllocation:
    """Allocate ``dag`` at every rate in ``omegas`` in one array pass.

    A rate no thread count supports raises
    :class:`~repro_torch.core.allocation.UnsupportableRateError` like the
    scalar allocators; with ``clip_unsupportable`` those cells instead get
    infinite CPU/mem (zero threads), so sweeping planners see them as
    infeasible at any budget rather than aborting the whole grid pass.

    ``speed`` is the slot speed of the target VM class: a thread on a
    ``speed=s`` slot serves ``s``× the profiled §6 service rate, so the
    allocator sizes threads/CPU/mem at the *effective* per-task rate
    ``beta_t * omega / s`` while :attr:`BatchAllocation.rates` keeps the
    real rates.
    """
    if speed <= 0:
        raise ValueError("speed must be positive")
    task_fn = _BATCH_ALLOCATORS[algorithm]
    omegas = np.asarray(omegas, dtype=float)
    betas = dag.get_rates(1.0)
    names, rates, threads, cpu, mem = [], [], [], [], []
    for t in dag.topo_order():
        model = models[t.kind]
        w_real = betas[t.name] * omegas
        w = w_real / speed
        if model.static:
            tau = np.ones_like(w, dtype=int)
            c = np.full_like(w, model.C(1))
            m = np.full_like(w, model.M(1))
        else:
            tau, c, m = task_fn(model, w, t.name, clip_unsupportable)
        names.append(t.name)
        rates.append(w_real)
        threads.append(tau)
        cpu.append(c)
        mem.append(m)
    return BatchAllocation(dag.name, algorithm, omegas, names,
                           np.stack(rates), np.stack(threads),
                           np.stack(cpu), np.stack(mem))


def batch_slots(dag: Dataflow, omegas: Sequence[float], models: ModelLibrary,
                algorithm: str = "mba",
                *, clip_unsupportable: bool = False, speed: float = 1.0,
                mem_per_slot: float = 1.0) -> np.ndarray:
    """Slot estimate rho for every rate — the bisection feasibility oracle.
    ``speed``/``mem_per_slot`` target a specific VM class (defaults: the
    homogeneous unit-slot model, bit-identical to the baseline)."""
    return batch_allocate(dag, omegas, models, algorithm,
                          clip_unsupportable=clip_unsupportable,
                          speed=speed).slots_for(mem_per_slot)


def batch_feasible(dags: Mapping[str, Dataflow] | Sequence[Dataflow],
                   omegas: Sequence[float], models: ModelLibrary,
                   *, algorithm: str = "mba", budget_slots: int,
                   clip_unsupportable: bool = True) -> Dict[str, np.ndarray]:
    """Fleet feasibility: per DAG, a boolean mask over ``omegas`` of rates
    whose slot estimate fits ``budget_slots``.  Unsupportable rates read as
    infeasible (one degenerate DAG must not abort the whole fleet's masks);
    pass ``clip_unsupportable=False`` for the raising scalar semantics."""
    if not isinstance(dags, Mapping):
        dags = {d.name: d for d in dags}
    return {name: batch_slots(dag, omegas, models, algorithm,
                              clip_unsupportable=clip_unsupportable)
            <= budget_slots
            for name, dag in dags.items()}


def prefix_feasible_count(feasible: np.ndarray) -> int:
    """Length of the leading all-True run — the §8.5 scan's stop semantics
    (it stops at the FIRST rate that does not fit, even if a later one
    would)."""
    feasible = np.asarray(feasible, dtype=bool)
    bad = np.flatnonzero(~feasible)
    return int(bad[0]) if bad.size else len(feasible)


def bisect_largest_true(predicate: Callable[[int], bool], n: int,
                        *, lo_known_true: bool = False) -> int:
    """Largest index ``i`` in ``[0, n)`` with ``predicate(i)`` True, assuming
    the predicate is prefix-monotone (True ... True False ... False); ``-1``
    if none.  O(log n) probes instead of the linear scan's O(n)."""
    if n <= 0:
        return -1
    lo = 0
    if not lo_known_true and not predicate(0):
        return -1
    if predicate(n - 1):
        return n - 1
    hi = n - 1  # invariant: predicate(lo) True, predicate(hi) False
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if predicate(mid):
            lo = mid
        else:
            hi = mid
    return lo
