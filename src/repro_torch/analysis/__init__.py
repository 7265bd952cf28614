"""Plan-integrity analysis for the port, copied from the JAX package's
``analysis``: the verifier passes the planner, controller and runtime
hooks call (:mod:`.verify`) and the static rate-stability prover
(:mod:`.prove`).  Both are numpy only; the planner imports them lazily,
as in the reference.  The prover is not imported here (it pulls in the
predictor): ``from repro_torch.analysis import prove``."""

from ..core.diagnostics import (       # noqa: F401  (re-exports)
    PlanIntegrityError,
    Report,
    Severity,
    Violation,
    default_validate,
    raise_if_errors,
    resolve_validate,
    set_default_validate,
)

from .verify import (                  # noqa: F401
    verify_allocation,
    verify_autorecal,
    verify_calibration,
    verify_controller,
    verify_dag,
    verify_enactment,
    verify_fleet_plan,
    verify_grid,
    verify_models,
    verify_rate_decisions,
    verify_schedule,
    verify_trace,
    verify_tracer,
)

__all__ = [
    "Violation", "Severity", "Report", "PlanIntegrityError",
    "raise_if_errors", "default_validate", "set_default_validate",
    "resolve_validate",
    "verify_dag", "verify_models", "verify_grid", "verify_allocation",
    "verify_schedule", "verify_fleet_plan", "verify_rate_decisions",
    "verify_trace", "verify_controller", "verify_enactment",
    "verify_calibration", "verify_tracer", "verify_autorecal",
]
