"""Typed plan-integrity diagnostics (shared by planner errors and the
:mod:`repro.analysis` verifier/lint layers).

Every check in the codebase — the artifact verifier's ~40 invariants, the
AST lint rules, and the planners' own :class:`UnsupportableRateError`
family — reports through one vocabulary: a :class:`Violation` carrying a
stable ``code`` (e.g. ``SCH_THREAD_UNPLACED``), a :class:`Severity`, the
artifact it was found on, a path *into* that artifact, and a human
detail line.  ``docs/INVARIANTS.md`` catalogs every code.

This module is dependency-free on purpose: ``repro.core`` modules import
it for error routing without ever touching :mod:`repro.analysis` (which
imports the whole core), so there is no import cycle.

The ``validate=`` mode of ``plan`` / ``plan_fleet`` /
``replan_incremental`` / ``FleetController.apply`` resolves through
:func:`resolve_validate`: an explicit ``True``/``False`` wins, ``None``
falls back to the process-wide default (off; the test suite turns it on
via an autouse conftest fixture, ``benchmarks/run.py --smoke`` turns it
on for the CI smoke, and the ``REPRO_VALIDATE=1`` environment variable
turns it on for ad-hoc runs).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Iterable, List, Optional, Sequence


class Severity(enum.Enum):
    WARNING = "warning"   # suspicious but not plan-breaking; never raises
    ERROR = "error"       # an invariant is broken; validate-mode raises

    def __str__(self) -> str:  # pragma: no cover - repr aid
        return self.value


@dataclasses.dataclass(frozen=True)
class Violation:
    """One diagnostic finding.

    ``code`` is a stable machine-readable identifier (``<LAYER>_<RULE>``,
    layers: DAG/MOD/ALC/SCH/FLT/TRC/CTL for the verifier, JAX/RACE for the
    lint).  ``artifact`` names what was checked (``Schedule[linear]``,
    ``src/repro/core/simulator.py``); ``path`` points inside it
    (``mapping.assignment[x#3]``, ``simulator.py:131``)."""

    code: str
    severity: Severity
    artifact: str
    path: str
    detail: str

    def __str__(self) -> str:
        return (f"{self.severity.value.upper():7s} {self.code} "
                f"{self.artifact} :: {self.path}: {self.detail}")


class PlanIntegrityError(RuntimeError):
    """An artifact failed verification with ERROR-severity violations.

    Raised by the ``validate=`` hooks; ``violations`` holds every finding
    of the failing pass (warnings included) for structured handling."""

    def __init__(self, violations: Sequence[Violation],
                 context: str = "") -> None:
        self.violations: List[Violation] = list(violations)
        errors = [v for v in self.violations if v.severity is Severity.ERROR]
        head = (f"{context}: " if context else "") + \
            f"{len(errors)} integrity error(s)"
        lines = [head] + ["  " + str(v) for v in self.violations]
        super().__init__("\n".join(lines))


@dataclasses.dataclass
class Report:
    """A collection of violations with severity views."""

    violations: List[Violation] = dataclasses.field(default_factory=list)

    def add(self, code: str, severity: Severity, artifact: str, path: str,
            detail: str) -> None:
        self.violations.append(Violation(code, severity, artifact, path,
                                         detail))

    def extend(self, violations: Iterable[Violation]) -> None:
        self.violations.extend(violations)

    @property
    def errors(self) -> List[Violation]:
        return [v for v in self.violations if v.severity is Severity.ERROR]

    @property
    def warnings(self) -> List[Violation]:
        return [v for v in self.violations if v.severity is Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return sorted({v.code for v in self.violations})

    def describe(self) -> str:
        if not self.violations:
            return "clean"
        return "\n".join(str(v) for v in self.violations)


def raise_if_errors(violations: Sequence[Violation], context: str = "") -> None:
    """Raise :class:`PlanIntegrityError` when any violation is an ERROR
    (warnings alone never raise — they are reported by the CLI only)."""
    if any(v.severity is Severity.ERROR for v in violations):
        raise PlanIntegrityError(violations, context)


# ---------------------------------------------------------------------------
# Process-wide validate default for the planner hooks.
# ---------------------------------------------------------------------------

_DEFAULT_VALIDATE = os.environ.get("REPRO_VALIDATE", "").lower() \
    not in ("", "0", "false", "no")


def default_validate() -> bool:
    """The process-wide fallback for ``validate=None`` planner calls."""
    return _DEFAULT_VALIDATE


def set_default_validate(on: bool) -> bool:
    """Set the fallback; returns the previous value (for restore)."""
    global _DEFAULT_VALIDATE
    prev = _DEFAULT_VALIDATE
    _DEFAULT_VALIDATE = bool(on)
    return prev


def resolve_validate(validate: Optional[bool]) -> bool:
    """Explicit ``True``/``False`` wins; ``None`` takes the default."""
    return default_validate() if validate is None else bool(validate)
