"""Plan-integrity static analysis for the port, copied from the JAX
package's ``analysis``:

* :mod:`.verify` — the verifier passes the planner, controller and runtime
  hooks call (numpy only; the planner imports them lazily);
* :mod:`.lint` — a stdlib-``ast`` walk over source files flagging JAX
  recompile hazards and race hazards (the reference's rules, unchanged:
  they lint any Python source);
* :mod:`.flow` (+ :mod:`.locks`, :mod:`.jaxflow`, over :mod:`.cfg`) —
  the interprocedural analyses: lock-order cycles (RACE210-212) and
  cross-function JAX trace hazards (JAX110-112);
* :mod:`.prove` — the static rate-stability prover (RATE301-309); not
  imported here (it pulls in the predictor):
  ``from repro_torch.analysis import prove``;
* :mod:`.sarif` — SARIF 2.1.0 output.

``python -m repro_torch.analysis`` is the reference's CLI under the port's
name; only ``prove --simulate`` touches a device (one sweep-kernel launch,
``--device``)."""

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

from .lint import (                    # noqa: F401
    RULES,
    lint_paths,
    lint_source,
)

from .flow import (                    # noqa: F401
    FLOW_RULES,
    Project,
    analyze_paths,
    analyze_project,
)

__all__ = [
    "Violation", "Severity", "Report", "PlanIntegrityError",
    "raise_if_errors", "default_validate", "set_default_validate",
    "resolve_validate",
    "verify_dag", "verify_models", "verify_grid", "verify_allocation",
    "verify_schedule", "verify_fleet_plan", "verify_rate_decisions",
    "verify_trace", "verify_controller", "verify_enactment",
    "verify_calibration", "verify_tracer", "verify_autorecal",
    "lint_source", "lint_paths", "RULES",
    "analyze_paths", "analyze_project", "Project", "FLOW_RULES",
]
