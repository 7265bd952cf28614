"""repro_torch.obs — the port's telemetry: tracing, metrics and the
scoreboard, copied from the reference's ``obs`` (stdlib only, so every
layer of the stack can import it):

- :mod:`repro_torch.obs.clock` — the shared clock seam; install a
  ``VirtualClock`` and every telemetry timestamp becomes deterministic.
- :mod:`repro_torch.obs.trace` — span tracing (``with obs.span("replan", ...)``)
  with JSONL / Chrome-Perfetto export via ``python -m repro_torch.obs export``.
- :mod:`repro_torch.obs.metrics` — process-wide counters/gauges/histograms with
  a zero-cost disabled path and Prometheus text exposition.
- :mod:`repro_torch.obs.scoreboard` — planned-vs-simulated-vs-measured residual
  series per DAG, the paper's "estimated vs actual" comparison as a
  first-class artifact.

Everything ships **disabled**; call :func:`enable` (or the per-pillar
``enable_tracing`` / ``enable_metrics``) to start recording.
"""

from . import clock, metrics
from .export import export_tracer, read_jsonl, write_chrome, write_jsonl
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      bridge_controller_log, counter, disable_metrics,
                      enable_metrics, gauge, histogram, metrics_enabled,
                      observe_controller_record, observe_execution_report,
                      prometheus_text, register_collector, reset_metrics,
                      snapshot)
from .scoreboard import Residual, ResidualStats, Sample, Scoreboard
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
    # scoreboard
    "Sample", "Residual", "ResidualStats", "Scoreboard",
    # export
    "export_tracer", "write_jsonl", "write_chrome", "read_jsonl",
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
