"""Task performance models (paper §5).

A :class:`PerfModel` holds the profile ``P_i : tau -> (omega, c, m)`` — for
``tau`` data-parallel threads of a task packed onto ONE resource slot: the
peak *stable* input rate ``omega`` (tuples/s) and the incremental CPU% and
memory% at that rate (fractions of one slot, 1.0 == 100%).

The functions of §6 are exposed with the paper's names:

* ``I(q)``       peak input rate supported with ``q`` threads on one slot
* ``C(q)/M(q)``  incremental CPU% / memory% with ``q`` threads on one slot
* ``T(omega)``   smallest ``q`` such that ``I(q) >= omega`` (inverse of I)
* ``omega_bar``  ``I(1)`` — peak rate of a single thread
* ``omega_hat``  ``max_q I(q)`` — best single-slot operating point
* ``tau_hat``    ``T(omega_hat)`` — thread count of the best operating point

Profiles are measured at coarse thread increments (``Delta_tau`` in Alg. 1);
queries between measured counts interpolate linearly, exactly the
interpolation the paper uses in §8.5.1 ("we interpolate between the available
thread values").
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

ArrayLike = Union[float, int, Sequence[float], np.ndarray]


@dataclasses.dataclass(frozen=True)
class ModelPoint:
    """One measured profile point: ``tau`` threads on one slot."""

    tau: int
    rate: float  # peak stable input rate (tuples/s)
    cpu: float   # incremental CPU% of the slot at that rate, 1.0 == 100%
    mem: float   # incremental memory% of the slot at that rate


class PerfModel:
    """Piecewise-linear performance model over measured thread counts.

    ``static=True`` marks tasks with a fixed allocation independent of rate
    (the paper's source/sink: 1 thread, fixed CPU%/mem%, §8.3).
    """

    def __init__(self, kind: str, points: Iterable[ModelPoint], *,
                 static: bool = False):
        pts = sorted(points, key=lambda p: p.tau)
        if not pts:
            raise ValueError("PerfModel needs at least one point")
        if pts[0].tau < 1:
            raise ValueError("thread counts must be >= 1")
        taus = [p.tau for p in pts]
        if len(set(taus)) != len(taus):
            raise ValueError("duplicate thread counts in model")
        self.kind = kind
        self.points: List[ModelPoint] = pts
        self.static = static
        # Vectorized interpolation tables (jnp.interp-style): a (0, 0) anchor
        # reproduces the below-first-point linear ramp, and np.interp's right
        # clamp reproduces the flat extension beyond the last measured count.
        self._xp = np.array([0.0] + [float(t) for t in taus])
        self._fp = {
            "rate": np.array([0.0] + [p.rate for p in pts]),
            "cpu": np.array([0.0] + [p.cpu for p in pts]),
            "mem": np.array([0.0] + [p.mem for p in pts]),
        }
        # Integer-grid peak rates 1..tau_max and their running max, for the
        # vectorized inverse T (I is piecewise linear between integer taus,
        # so the integer grid is exact).
        self._int_rates = np.interp(np.arange(1, taus[-1] + 1, dtype=float),
                                    self._xp, self._fp["rate"])
        self._int_cummax = np.maximum.accumulate(self._int_rates)

    # -- interpolation helpers ---------------------------------------------
    def _eval(self, q: ArrayLike, field: str):
        """Scalar or array evaluation of one profile field at ``q`` threads.

        Piecewise linear over the measured counts with a (0, 0) anchor below
        the first point (0 threads do no work and use no incremental
        resources) and a flat extension beyond the last (where Alg. 1
        terminated because the rate had flattened or dropped).  Scalars and
        arrays share the same ``np.interp`` tables, so batch evaluation is
        bit-identical to the scalar path.
        """
        if np.ndim(q) == 0:
            if q <= 0:
                return 0.0
            return float(np.interp(float(q), self._xp, self._fp[field]))
        q = np.asarray(q, dtype=float)
        return np.interp(np.clip(q, 0.0, None), self._xp, self._fp[field])

    # -- paper-named accessors ----------------------------------------------
    def I(self, q: ArrayLike):  # noqa: E743  (paper notation)
        """Peak stable input rate with ``q`` threads on one slot.

        Accepts a scalar or an array of thread counts; array inputs are
        evaluated in one vectorized pass (the batch planning engine's path).
        """
        return self._eval(q, "rate")

    def C(self, q: ArrayLike):
        return self._eval(q, "cpu")

    def M(self, q: ArrayLike):
        return self._eval(q, "mem")

    def T(self, omega: float) -> Optional[int]:
        """Smallest integer thread count whose peak rate covers ``omega``,
        or None if no measured count supports it (caller then works in full
        bundles at ``omega_hat``)."""
        if omega <= 0:
            return 0
        t = int(self.T_many(omega))
        return None if t < 0 else t

    def T_many(self, omegas: ArrayLike):
        """Vectorized inverse of I: smallest integer thread count supporting
        each rate, ``-1`` where even the best measured count falls short
        (the scalar ``T``'s None), ``0`` for non-positive rates.

        I is piecewise linear between integer thread counts, so the first
        integer ``q`` with ``I(q) >= omega`` equals the first index where the
        running max of the integer-grid rates crosses ``omega`` — a single
        ``searchsorted`` on the (non-decreasing) running max.
        """
        omegas = np.asarray(omegas, dtype=float)
        idx = np.searchsorted(self._int_cummax, omegas - 1e-12, side="left")
        out = idx + 1  # grid index 0 is tau=1
        out = np.where(idx >= len(self._int_cummax), -1, out)
        return np.where(omegas <= 0, 0, out)

    @property
    def omega_bar(self) -> float:
        return self.I(1)

    @property
    def omega_hat(self) -> float:
        return max(p.rate for p in self.points)

    @property
    def tau_hat(self) -> int:
        """Smallest measured thread count achieving ``omega_hat``."""
        peak = self.omega_hat
        t = self.T(peak)
        assert t is not None
        return t

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "static": self.static,
            "points": [[p.tau, p.rate, p.cpu, p.mem] for p in self.points],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "PerfModel":
        return cls(d["kind"], [ModelPoint(int(t), float(r), float(c), float(m))
                               for t, r, c, m in d["points"]],
                   static=bool(d.get("static", False)))

    @classmethod
    def from_points(cls, kind: str,
                    pts: Mapping[int, Tuple[float, float, float]],
                    *, static: bool = False) -> "PerfModel":
        return cls(kind, [ModelPoint(t, *v) for t, v in pts.items()],
                   static=static)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PerfModel({self.kind!r}, tau=1..{self.points[-1].tau}, "
                f"omega_hat={self.omega_hat:.3g}@{self.tau_hat})")


# ---------------------------------------------------------------------------
# Algorithm 1: automated performance modeling of a task.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrialResult:
    """Outcome of one micro-benchmark trial (RunTaskTrial in Alg. 1)."""

    cpu: float               # CPU% at this rate (1.0 == 100%)
    mem: float               # memory%
    latencies: Sequence[float]  # per-tuple end-to-end latency samples, in order
    supported_rate: float    # realized ingest rate (== omega when stable)


TrialRunner = Callable[[int, float], TrialResult]


def latency_slope(latencies: Sequence[float]) -> float:
    """Least-squares slope of latency vs tuple index (stability test, §5.1).

    Under a stable configuration latencies are flat (slope ~ 0); an
    overloaded task shows unbounded queue growth and a positive slope.
    """
    n = len(latencies)
    if n < 2:
        return 0.0
    mean_x = (n - 1) / 2.0
    mean_y = sum(latencies) / n
    num = sum((i - mean_x) * (y - mean_y) for i, y in enumerate(latencies))
    den = sum((i - mean_x) ** 2 for i in range(n))
    return num / den if den else 0.0


def window_slope(values: Sequence[float]) -> float:
    """Slope over the trailing window of peak rates (thread-sweep stop)."""
    return latency_slope(values)


def build_perf_model(
    kind: str,
    run_trial: TrialRunner,
    *,
    tau_max: int = 64,
    delta_tau: Callable[[int], int] = lambda t: 1 if t < 4 else max(1, t // 2),
    omega_start: float = 1.0,
    omega_max: float = 1e6,
    delta_omega: Callable[[float], float] = lambda w: max(1.0, w * 0.25),
    lambda_l_max: float = 1e-3,
    lambda_w_min: float = -1e-3,
    rate_window: int = 3,
) -> PerfModel:
    """Algorithm 1 (PerfModel): constrained sweep of threads x input rate.

    ``run_trial(tau, omega)`` runs the 3-task trial DAG (source -> task ->
    sink) and returns latency samples + resource usage.  Stability is judged
    by the latency slope ``lambda_L <= lambda_l_max``.  The thread sweep stops
    at ``tau_max`` or when the slope of the trailing window of peak rates is
    flat/negative (``<= lambda_w_min`` after at least ``rate_window`` counts).
    """
    profile: Dict[int, ModelPoint] = {}
    peak_rates: List[float] = []
    tau = 1
    while tau <= tau_max:
        omega = omega_start
        best: Optional[ModelPoint] = None
        while omega <= omega_max:
            res = run_trial(tau, omega)
            stable = latency_slope(res.latencies) <= lambda_l_max
            if not stable:
                break
            best = ModelPoint(tau, omega, res.cpu, res.mem)
            omega = omega + delta_omega(omega)
        if best is not None:
            profile[tau] = best
            peak_rates.append(best.rate)
        else:
            # Not even the starting rate is stable with this thread count:
            # record a zero-rate point only if we have nothing else.
            peak_rates.append(0.0)
        if len(peak_rates) >= rate_window:
            lam = window_slope(peak_rates[-rate_window:])
            if lam <= lambda_w_min or (lam <= 0 and len(peak_rates) > rate_window):
                break
        tau += delta_tau(tau)
    if not profile:
        raise RuntimeError(f"no stable configuration found for task {kind!r}")
    return PerfModel(kind, profile.values())


# ---------------------------------------------------------------------------
# Seeded models reproducing the measured profiles of Fig. 3 (§5.3).
#
# These encode the paper's published datapoints so that allocation/mapping
# experiments are exactly reproducible without re-profiling; the live
# profiler (repro.core.profiler) can regenerate models of the same shape
# from actual CPU micro-benchmarks.
#
# Units: rate = tuples/s on one slot; cpu/mem = fraction of one slot.
# ---------------------------------------------------------------------------

PAPER_MODELS: Dict[str, PerfModel] = {
    # Fig. 3a: peak 310 t/s @1 thread, declining to ~255 @7; CPU ~85% @1;
    # memory ~35% (string-heavy).
    "parse_xml": PerfModel.from_points("parse_xml", {
        1: (310.0, 0.85, 0.23),
        2: (300.0, 0.90, 0.27),
        3: (290.0, 0.93, 0.30),
        5: (270.0, 0.96, 0.33),
        7: (255.0, 0.98, 0.35),
    }),
    # Fig. 3b: 105 t/s @1 (CPU ~90%), modest bump to 110 @2, then drop + flat.
    "pi": PerfModel.from_points("pi", {
        1: (105.0, 0.90, 0.02),
        2: (110.0, 0.95, 0.04),
        3: (100.0, 0.95, 0.06),
        5: (100.0, 0.95, 0.08),
        8: (100.0, 0.95, 0.10),
    }),
    # Fig. 3c: 60k t/s @1, sharp drop to 45k @3 (disk contention), recovers
    # and stabilizes ~50k.
    "batch_file_write": PerfModel.from_points("batch_file_write", {
        1: (60000.0, 0.60, 0.15),
        2: (52000.0, 0.55, 0.18),
        3: (45000.0, 0.50, 0.20),
        5: (50000.0, 0.65, 0.24),
        8: (50000.0, 0.75, 0.28),
    }),
    # Fig. 3d: bell curve, 2 t/s @1 -> ~30 t/s @50, flattens/drops beyond;
    # memory-heavy (2MB in-memory file per tuple), m_bar ~ 23.9%/thread is
    # the paper's single-thread LSA figure (§8.4.1); the bundle at 50
    # threads, however, uses far less than 50x that (~96%).
    "azure_blob": PerfModel.from_points("azure_blob", {
        1: (2.0, 0.065, 0.239),
        5: (6.0, 0.12, 0.32),
        10: (10.0, 0.18, 0.42),
        20: (18.0, 0.30, 0.58),
        30: (24.0, 0.45, 0.72),
        40: (28.0, 0.60, 0.85),
        50: (30.0, 0.75, 0.96),
        60: (29.0, 0.80, 0.99),
    }),
    # Fig. 3e: 3 t/s @1 -> 60 t/s @60, then flat/drop; CPU and memory grow
    # with very different slopes.
    "azure_table": PerfModel.from_points("azure_table", {
        1: (3.0, 0.03, 0.05),
        2: (5.0, 0.05, 0.07),
        5: (9.0, 0.09, 0.11),
        9: (10.0, 0.14, 0.16),
        20: (22.0, 0.28, 0.30),
        40: (42.0, 0.52, 0.52),
        60: (60.0, 0.78, 0.70),
        70: (58.0, 0.82, 0.74),
    }),
    # §8.3: source/sink are light, single-thread, statically allocated
    # (10% CPU / 15% mem source; 10% CPU / 20% mem sink).  Their rate is
    # effectively unbounded for the rates studied; use a high ceiling.
    "source": PerfModel.from_points("source", {1: (1e6, 0.10, 0.15)}, static=True),
    "sink": PerfModel.from_points("sink", {1: (1e6, 0.10, 0.20)}, static=True),
}


class ModelLibrary:
    """Keyed collection of PerfModels consulted by allocation/mapping."""

    def __init__(self, models: Optional[Mapping[str, PerfModel]] = None):
        self._models: Dict[str, PerfModel] = dict(models or {})

    def __getitem__(self, kind: str) -> PerfModel:
        try:
            return self._models[kind]
        except KeyError:
            raise KeyError(f"no performance model for task kind {kind!r}") from None

    def __contains__(self, kind: str) -> bool:
        return kind in self._models

    def add(self, model: PerfModel) -> None:
        self._models[model.kind] = model

    def kinds(self) -> List[str]:
        return sorted(self._models)

    def to_json(self) -> str:
        return json.dumps({k: m.to_dict() for k, m in self._models.items()},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ModelLibrary":
        raw = json.loads(s)
        return cls({k: PerfModel.from_dict(v) for k, v in raw.items()})


def paper_library() -> ModelLibrary:
    return ModelLibrary(PAPER_MODELS)
