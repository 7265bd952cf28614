"""Predicted-vs-actual scoreboard.

Joins, per DAG, what the planner *promised* (planned rate, predicted
CPU/mem from :class:`FleetPlan` / ``predict_resources``) against what the
simulator (:meth:`FleetController.cosimulate` / ``simulate_fleet``) and
the live runtime (:class:`ExecutionReport` measurement windows) actually
delivered, as residual series with summary error statistics.

Semantics of the rate join: a cosimulation entry *sustains* the plan when
``planned_is_stable`` (the sweep's maximum stable rate reaches the
planned operating point), in which case the observed sustained rate is
exactly the planned rate and the residual is exactly ``0.0`` — the
fault-free rail is bit-clean, not approximately clean.  When the sweep
tops out below the plan, the observed value is ``actual_max_stable`` and
the residual goes negative, which is the drift signal auto-recalibration
acts on.

All ingestion is duck-typed on the planner/runtime dataclasses so this
module stays dependency-free and import-cycle-free.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = ["Sample", "Residual", "ResidualStats", "Scoreboard"]

PLANNED = "planned"
SIMULATED = "simulated"
MEASURED = "measured"


@dataclasses.dataclass(frozen=True)
class Sample:
    """One observation: ``(dag, metric, source) -> value`` at time ``t``."""

    dag: str
    metric: str      # "rate" | "cpu" | "mem" | ...
    source: str      # "planned" | "simulated" | "measured"
    value: float
    t: float = 0.0


@dataclasses.dataclass(frozen=True)
class Residual:
    """An observed sample paired with the prediction it tests."""

    dag: str
    metric: str
    source: str          # where the observation came from
    expected: float      # the planner's promise
    observed: float
    t: float = 0.0

    @property
    def residual(self) -> float:
        return self.observed - self.expected

    @property
    def relative(self) -> float:
        """Residual as a fraction of the promise (NaN when expected==0)."""
        if self.expected == 0.0:
            return math.nan if self.observed != 0.0 else 0.0
        return self.residual / self.expected


@dataclasses.dataclass(frozen=True)
class ResidualStats:
    """Summary error statistics for one ``(dag, metric, source)`` series."""

    dag: str
    metric: str
    source: str
    n: int
    mean_abs: float
    rmse: float
    max_abs: float
    mean_abs_relative: float

    @property
    def exact(self) -> bool:
        """True when every residual in the series is exactly zero."""
        return self.max_abs == 0.0


class Scoreboard:
    """Accumulates promises and observations; reports residuals."""

    def __init__(self) -> None:
        self._samples: List[Sample] = []

    # -- raw ingestion -------------------------------------------------

    def record(self, dag: str, metric: str, source: str, value: float,
               t: float = 0.0) -> Sample:
        sample = Sample(str(dag), str(metric), str(source), float(value),
                        float(t))
        self._samples.append(sample)
        return sample

    @property
    def samples(self) -> List[Sample]:
        return list(self._samples)

    def __len__(self) -> int:
        return len(self._samples)

    # -- planner side --------------------------------------------------

    def ingest_fleet_plan(self, plan: Any, t: float = 0.0) -> int:
        """Record planned rate and predicted CPU/mem per FleetPlan entry."""
        n = 0
        entries = plan.entries
        if hasattr(entries, "values"):  # FleetPlan keeps a dict
            entries = entries.values()
        for entry in entries:
            self.record(entry.name, "rate", PLANNED, entry.omega, t)
            n += 1
            prediction = getattr(entry, "prediction", None)
            if prediction is None:
                continue
            cpu = getattr(prediction, "vm_cpu", None)
            mem = getattr(prediction, "vm_mem", None)
            if cpu is not None:
                self.record(entry.name, "cpu", PLANNED,
                            float(_total(cpu)), t)
            if mem is not None:
                self.record(entry.name, "mem", PLANNED,
                            float(_total(mem)), t)
        return n

    def ingest_controller(self, controller: Any, t: float = 0.0) -> int:
        """Record each live DAG's planned rate straight off the controller."""
        n = 0
        for name in controller.dag_names:
            self.record(name, "rate", PLANNED, controller.entry(name).omega, t)
            n += 1
        return n

    # -- simulated side ------------------------------------------------

    def ingest_cosim(self, report: Any, t: float = 0.0) -> int:
        """Record sustained rates from a :class:`FleetSimReport`.

        The observed value is the planned rate itself when the entry
        proved/simulated stable at its operating point (residual exactly
        zero), else the sweep's measured ceiling ``actual_max_stable``.
        """
        n = 0
        entries = report.entries
        if hasattr(entries, "values"):  # FleetSimReport keeps a dict
            entries = entries.values()
        for entry in entries:
            sustained = (entry.omega_planned if entry.planned_is_stable
                         else float(entry.actual_max_stable))
            self.record(entry.name, "rate", SIMULATED, sustained, t)
            n += 1
        if getattr(report, "vm_cpu_predicted", None) is not None:
            # fleet-level resource residuals ride along when present
            self.record("<fleet>", "cpu", PLANNED,
                        float(_total(report.vm_cpu_predicted)), t)
            self.record("<fleet>", "cpu", SIMULATED,
                        float(_total(report.vm_cpu_actual)), t)
        if getattr(report, "vm_mem_predicted", None) is not None:
            self.record("<fleet>", "mem", PLANNED,
                        float(_total(report.vm_mem_predicted)), t)
            self.record("<fleet>", "mem", SIMULATED,
                        float(_total(report.vm_mem_actual)), t)
        return n

    def ingest_verdicts(self, rates: Mapping[str, float],
                        stable: Mapping[str, bool], t: float = 0.0) -> int:
        """Record sustained rates from a controller co-sim verdict dict."""
        n = 0
        for name, omega in rates.items():
            ok = bool(stable.get(name, False))
            self.record(name, "rate", SIMULATED,
                        float(omega) if ok else 0.0, t)
            n += 1
        return n

    # -- measured side -------------------------------------------------

    def ingest_reports(self, reports: Mapping[str, Any],
                       t: float = 0.0) -> int:
        """Record measured throughput from ExecutionReport windows."""
        n = 0
        for name, report in reports.items():
            self.record(name, "rate", MEASURED, float(report.throughput), t)
            n += 1
        return n

    # -- residuals -----------------------------------------------------

    def _latest_expected(self, dag: str, metric: str,
                         before: float) -> Optional[Sample]:
        best: Optional[Sample] = None
        for sample in self._samples:
            if (sample.dag == dag and sample.metric == metric
                    and sample.source == PLANNED and sample.t <= before):
                if best is None or sample.t >= best.t:
                    best = sample
        return best

    def residuals(self, metric: str = "rate",
                  source: str = SIMULATED,
                  dag: Optional[str] = None) -> List[Residual]:
        """Pair every observation with the newest promise at-or-before it."""
        out: List[Residual] = []
        for sample in self._samples:
            if sample.source != source or sample.metric != metric:
                continue
            if dag is not None and sample.dag != dag:
                continue
            promise = self._latest_expected(sample.dag, metric, sample.t)
            if promise is None:
                continue
            out.append(Residual(sample.dag, metric, source,
                                expected=promise.value,
                                observed=sample.value, t=sample.t))
        return out

    def residual_series(self, dag: str, metric: str = "rate",
                        source: str = SIMULATED) -> List[float]:
        return [r.residual for r in self.residuals(metric, source, dag)]

    def summary(self, metric: str = "rate",
                source: str = SIMULATED) -> Dict[str, ResidualStats]:
        """Per-DAG error statistics over the residual series."""
        by_dag: Dict[str, List[Residual]] = {}
        for residual in self.residuals(metric, source):
            by_dag.setdefault(residual.dag, []).append(residual)
        out: Dict[str, ResidualStats] = {}
        for name, series in sorted(by_dag.items()):
            values = [r.residual for r in series]
            relatives = [abs(r.relative) for r in series
                         if not math.isnan(r.relative)]
            out[name] = ResidualStats(
                dag=name, metric=metric, source=source, n=len(values),
                mean_abs=sum(abs(v) for v in values) / len(values),
                rmse=math.sqrt(sum(v * v for v in values) / len(values)),
                max_abs=max(abs(v) for v in values),
                mean_abs_relative=(sum(relatives) / len(relatives)
                                   if relatives else 0.0),
            )
        return out

    def planned_sustained(self, source: str = SIMULATED,
                          tol: float = 0.0) -> Dict[str, bool]:
        """Per-DAG verdicts ``residual >= -tol`` — the shape that feeds
        :func:`repro_torch.core.calibrate.detect_drift` as its verdict side."""
        verdicts: Dict[str, bool] = {}
        for name, stats in self.summary("rate", source).items():
            series = self.residual_series(name, "rate", source)
            verdicts[name] = series[-1] >= -tol if series else False
        return verdicts

    def describe(self) -> str:
        lines = [f"Scoreboard: {len(self._samples)} samples"]
        for source in (SIMULATED, MEASURED):
            for name, stats in self.summary("rate", source).items():
                lines.append(
                    f"  {name:<12} rate vs {source:<9} n={stats.n} "
                    f"mean|r|={stats.mean_abs:.4g} rmse={stats.rmse:.4g} "
                    f"max|r|={stats.max_abs:.4g}"
                    + ("  EXACT" if stats.exact else ""))
        return "\n".join(lines)


def _total(values: Any) -> float:
    """Sum a mapping / array-like / scalar without importing numpy."""
    if hasattr(values, "values") and callable(values.values):
        return float(sum(values.values()))  # per-VM dicts
    total = getattr(values, "sum", None)
    if callable(total):
        return float(total())  # numpy arrays
    try:
        return float(sum(values))
    except TypeError:
        return float(values)
