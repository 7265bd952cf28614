"""repro_torch.obs — the port's telemetry: the clock seam, span tracing and
metrics, copied from the reference's ``obs`` (stdlib only).

- :mod:`repro_torch.obs.clock` — the shared clock seam.
- :mod:`repro_torch.obs.trace` — span tracing (``with obs.span(...)``,
  ``@obs.trace("plan")``).
- :mod:`repro_torch.obs.metrics` — process-wide counters/gauges/histograms
  with a zero-cost disabled path; the sweep-kernel cache publishes its
  stats through a collector registered here.

The scoreboard, the export helpers and the CLI come with the runtime.
Everything ships **disabled**; call :func:`enable` (or the per-pillar
``enable_tracing`` / ``enable_metrics``) to start recording.
"""

from . import clock, metrics
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      bridge_controller_log, counter, disable_metrics,
                      enable_metrics, gauge, histogram, metrics_enabled,
                      observe_controller_record, observe_execution_report,
                      prometheus_text, register_collector, reset_metrics,
                      snapshot)
from .trace import (SpanRecord, Tracer, disable_tracing, enable_tracing,
                    get_tracer, set_tracer, span, trace, tracing_enabled)

__all__ = [
    # clock seam
    "clock",
    # tracing
    "SpanRecord", "Tracer", "span", "trace", "get_tracer", "set_tracer",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "enable_metrics", "disable_metrics",
    "metrics_enabled", "register_collector", "prometheus_text", "snapshot",
    "reset_metrics", "observe_controller_record", "bridge_controller_log",
    "observe_execution_report", "metrics",
    # umbrella switches
    "enable", "disable",
]


def enable() -> None:
    """Turn on both tracing and metrics."""
    enable_tracing(True)
    enable_metrics(True)


def disable() -> None:
    """Turn off both tracing and metrics."""
    disable_tracing()
    disable_metrics()
