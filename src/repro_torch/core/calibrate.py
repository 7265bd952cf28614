"""Measured-model recalibration: the planner's tables track reality.

The executor accumulates per-(task, slot-group) service samples —
``tuples`` processed and the ``busy_seconds`` spent processing them —
whose ratio is the *measured* peak service rate of that operator kind at
that thread count.  :func:`recalibrate` folds those samples back into the
:class:`~repro_torch.core.perfmodel.PerfModel` tables:

1.  Per operator kind, form the tuple-weighted mean of the
    measured/predicted rate ratios ``r_i = measured_i / I(tau_i)``.
2.  EWMA-damp the update: the table's rate column is scaled by
    ``f = 1 + alpha * (r - 1)`` — an exponentially-weighted average
    between the old table (weight ``1 - alpha``) and the fully-measured
    table (weight ``alpha``), so one noisy window cannot whipsaw the
    planner.
3.  **Bit-identical rail:** when ``|f - 1| <= tol`` the kind's model is
    *unchanged* — the very same :class:`PerfModel` object is returned, so
    recalibrating against exact analytic profiles is a provable no-op.

CPU/memory columns and the measured thread-count grid are preserved: a
recalibration is a uniform positive rescale of the rate column, which
keeps interpolation soundness (``CAL_TABLE_NONMONOTONE`` in
:mod:`repro_torch.analysis.verify` checks exactly this contract).

:func:`detect_drift` is the watch-dog half of the loop: it compares the
executor's *measured* stability verdicts (latency slopes) against the
controller's ``cosimulate()`` predictions and reports every DAG where
model and reality disagree — the trigger for a recalibration pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional

from .diagnostics import resolve_validate
from .perfmodel import ModelLibrary, ModelPoint, PerfModel

__all__ = [
    "TaskMeasurement", "KindCalibration", "CalibrationResult",
    "DriftAlert", "AutoRecalPolicy", "recalibrate", "detect_drift",
    "rate_error",
]


@dataclasses.dataclass(frozen=True)
class TaskMeasurement:
    """One measured service sample: a (task, slot-group) window."""

    kind: str            # operator kind (the PerfModel key)
    task: str            # task instance the sample came from
    tau: int             # threads in the measured slot group
    tuples: float        # tuples processed in the window
    busy_seconds: float  # busy time spent processing them

    @property
    def rate(self) -> float:
        """Measured peak service rate (tuples/s) of the group."""
        return self.tuples / self.busy_seconds


@dataclasses.dataclass(frozen=True)
class KindCalibration:
    """One operator kind's recalibration outcome."""

    kind: str
    samples: int
    ratio: float     # tuple-weighted mean measured/predicted rate ratio
    factor: float    # damped rescale applied: 1 + alpha * (ratio - 1)
    changed: bool    # False -> the model object was returned untouched


@dataclasses.dataclass
class CalibrationResult:
    """A recalibrated library plus the evidence it was built from."""

    library: ModelLibrary
    per_kind: Dict[str, KindCalibration]
    alpha: float
    #: tuple-weighted mean |measured/predicted - 1| against the OLD tables
    error_before: float
    #: same error against the recalibrated tables, on the SAME measurements
    error_after: float

    @property
    def changed_kinds(self) -> List[str]:
        return [k for k, c in self.per_kind.items() if c.changed]

    def describe(self) -> str:
        lines = [f"Calibration(alpha={self.alpha:g}): "
                 f"error {self.error_before:.4f} -> {self.error_after:.4f}"]
        for k in sorted(self.per_kind):
            c = self.per_kind[k]
            tag = f"x{c.factor:.4f}" if c.changed else "unchanged"
            lines.append(f"  {k:<18} ratio={c.ratio:.4f} {tag} "
                         f"({c.samples} samples)")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class DriftAlert:
    """Model and measurement disagree about one DAG's stability."""

    dag: str
    predicted_stable: bool
    measured_stable: bool
    measured_slope: float
    detail: str


@dataclasses.dataclass(frozen=True)
class AutoRecalPolicy:
    """Knobs for closed-loop auto-recalibration inside ``LiveFleet``.

    The live fleet EWMA-damps the per-event measured rate error
    (``smoothing`` is the weight of the newest sample); when the damped
    magnitude crosses ``threshold`` it confirms against its own
    ``DriftAlert`` stream and — if model and measurement genuinely
    disagree — enacts :func:`recalibrate` (damping ``alpha``) through
    :meth:`~repro_torch.core.online.FleetController.recalibrate`.  At least
    ``cooldown_events`` controller events must separate two
    recalibrations, so oscillating drift cannot thrash the tables
    (``CAL_AUTO_RECAL_LOOP`` in :mod:`repro_torch.analysis.verify` enforces the
    spacing on the recorded timeline).
    """

    threshold: float = 0.15      # damped |rate error| that arms a recal
    cooldown_events: int = 3     # min controller events between recals
    alpha: float = 0.9           # EWMA damping passed to recalibrate()
    smoothing: float = 0.5       # EWMA weight of the newest error sample
    confirm_with_drift: bool = True  # require a nonempty DriftAlert stream

    def __post_init__(self) -> None:
        if not 0.0 < self.smoothing <= 1.0:
            raise ValueError("smoothing must be in (0, 1]")
        if self.threshold < 0.0:
            raise ValueError("threshold must be >= 0")
        if self.cooldown_events < 1:
            raise ValueError("cooldown_events must be >= 1")


def _scaled_model(model: PerfModel, factor: float) -> PerfModel:
    """The same profile with its rate column uniformly rescaled.

    Thread-count grid, CPU and memory columns, and the ``static`` flag are
    preserved — the contract ``verify_calibration`` enforces.
    """
    pts = [ModelPoint(p.tau, p.rate * factor, p.cpu, p.mem)
           for p in model.points]
    return PerfModel(model.kind, pts, static=model.static)


def rate_error(models: ModelLibrary,
               measurements: Iterable[TaskMeasurement]) -> float:
    """Tuple-weighted mean relative rate error |measured/predicted - 1|
    of ``measurements`` against ``models`` (0.0 with no usable samples)."""
    num = den = 0.0
    for m in measurements:
        if m.busy_seconds <= 0 or m.tuples <= 0:
            continue
        pred = float(models[m.kind].I(m.tau)) if m.kind in models else 0.0
        if pred <= 0:
            continue
        num += m.tuples * abs(m.rate / pred - 1.0)
        den += m.tuples
    return num / den if den > 0 else 0.0


def recalibrate(models: ModelLibrary,
                measurements: Iterable[TaskMeasurement], *,
                alpha: float = 0.9, tol: float = 1e-6,
                validate: Optional[bool] = None) -> CalibrationResult:
    """Fold measured service rates back into the model tables (EWMA-damped).

    ``alpha`` is the damping weight on the measured table (0 = ignore
    measurement, 1 = jump fully to it); ``tol`` is the dead-band below
    which a kind's model is returned bit-identical.  Kinds without samples
    keep their exact model objects.  With ``validate`` (or the process-wide
    default) on, the result is checked by
    :func:`repro_torch.analysis.verify.verify_calibration`.
    """
    if not 0.0 <= alpha <= 1.0:
        raise ValueError("alpha must be in [0, 1]")
    samples = [m for m in measurements
               if m.busy_seconds > 0 and m.tuples > 0 and m.kind in models]
    by_kind: Dict[str, List[TaskMeasurement]] = {}
    for m in samples:
        by_kind.setdefault(m.kind, []).append(m)

    per_kind: Dict[str, KindCalibration] = {}
    out = ModelLibrary()
    for kind in models.kinds():
        model = models[kind]
        ms = by_kind.get(kind, [])
        num = den = 0.0
        for m in ms:
            pred = float(model.I(m.tau))
            if pred <= 0:
                continue
            num += m.tuples * (m.rate / pred)
            den += m.tuples
        if den <= 0:
            out.add(model)    # no evidence: exact same object
            if ms:
                per_kind[kind] = KindCalibration(kind, len(ms), 1.0, 1.0,
                                                 changed=False)
            continue
        ratio = num / den
        factor = 1.0 + alpha * (ratio - 1.0)
        if abs(factor - 1.0) <= tol or factor <= 0:
            # dead-band (or degenerate): bit-identical no-op
            out.add(model)
            per_kind[kind] = KindCalibration(kind, len(ms), ratio, 1.0,
                                             changed=False)
            continue
        out.add(_scaled_model(model, factor))
        per_kind[kind] = KindCalibration(kind, len(ms), ratio, factor,
                                         changed=True)

    result = CalibrationResult(
        library=out, per_kind=per_kind, alpha=alpha,
        error_before=rate_error(models, samples),
        error_after=rate_error(out, samples))
    if resolve_validate(validate):
        from ..analysis.verify import verify_calibration
        from .diagnostics import raise_if_errors
        raise_if_errors(verify_calibration(models, result))
    return result


def detect_drift(verdicts: Mapping[str, bool],
                 reports: Mapping[str, object]) -> List[DriftAlert]:
    """Compare ``cosimulate()`` stability verdicts against measured
    executor reports (duck-typed: ``.stable``, ``.latency_slope``,
    ``.stable_reason``) and return one alert per disagreeing DAG."""
    alerts: List[DriftAlert] = []
    for name in sorted(verdicts):
        rep = reports.get(name)
        if rep is None:
            continue
        predicted = bool(verdicts[name])
        measured = bool(getattr(rep, "stable", False))
        if predicted == measured:
            continue
        slope = float(getattr(rep, "latency_slope", 0.0))
        reason = str(getattr(rep, "stable_reason", ""))
        detail = (f"cosimulate says {'stable' if predicted else 'unstable'}, "
                  f"measurement says {'stable' if measured else 'unstable'} "
                  f"(slope {slope:.4g} s/frame"
                  + (f"; {reason}" if reason else "") + ")")
        alerts.append(DriftAlert(dag=name, predicted_stable=predicted,
                                 measured_stable=measured,
                                 measured_slope=slope, detail=detail))
    return alerts
