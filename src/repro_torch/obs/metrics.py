"""Process-wide metrics registry: counters, gauges, histograms.

Design goals, in order:

1. **Free when off.**  Every instrument's hot method starts with
   ``if not self._registry.enabled: return`` — no lock, no allocation.
   The registry ships disabled; :func:`enable_metrics` turns it on.
2. **Thread-safe when on.**  All mutation happens under one registry
   lock; instruments are registered idempotently by ``(name, labels)``.
3. **Dependency-free exposition.**  :func:`prometheus_text` renders the
   Prometheus text format; :meth:`MetricsRegistry.snapshot` returns plain
   dicts for JSON.

Collectors (e.g. the scan-kernel cache bridge in ``core.simulator``) are
callables invoked right before a snapshot/exposition so pull-style
sources publish without a background thread.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "enable_metrics", "disable_metrics",
    "metrics_enabled", "register_collector", "prometheus_text", "snapshot",
    "reset_metrics", "observe_controller_record", "bridge_controller_log",
    "observe_execution_report",
]

LabelPairs = Tuple[Tuple[str, str], ...]

# Latency-flavoured default buckets: 100µs .. 10s, roughly log-spaced.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Raw samples kept per histogram for exact percentiles; beyond the cap the
# reservoir keeps the most recent samples (benchmark runs stay well under).
_HIST_SAMPLE_CAP = 4096


class _Instrument:
    __slots__ = ("name", "help", "unit", "labels", "_registry")

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 unit: str, labels: LabelPairs) -> None:
        self._registry = registry
        self.name = name
        self.help = help
        self.unit = unit
        self.labels = labels


class Counter(_Instrument):
    """Monotonically increasing total."""

    __slots__ = ("_value",)

    kind = "counter"

    def __init__(self, *args: Any) -> None:
        super().__init__(*args)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with registry._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _sample(self) -> Dict[str, Any]:
        return {"value": self._value}


class Gauge(_Instrument):
    """Last-write-wins scalar."""

    __slots__ = ("_value",)

    kind = "gauge"

    def __init__(self, *args: Any) -> None:
        super().__init__(*args)
        self._value = 0.0

    def set(self, value: float) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        with registry._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        with registry._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _sample(self) -> Dict[str, Any]:
        return {"value": self._value}


class Histogram(_Instrument):
    """Distribution with cumulative buckets and exact recent percentiles."""

    __slots__ = ("buckets", "_bucket_counts", "_count", "_sum", "_samples")

    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 unit: str, labels: LabelPairs,
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        super().__init__(registry, name, help, unit, labels)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._count = 0
        self._sum = 0.0
        self._samples: List[float] = []

    def observe(self, value: float) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        value = float(value)
        with registry._lock:
            self._count += 1
            self._sum += value
            self._bucket_counts[bisect.bisect_left(self.buckets, value)] += 1
            if len(self._samples) >= _HIST_SAMPLE_CAP:
                self._samples.pop(0)
            self._samples.append(value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Exact percentile over retained samples (q in [0, 100])."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile {q} outside [0, 100]")
        with self._registry._lock:
            data = sorted(self._samples)
        if not data:
            return math.nan
        if len(data) == 1:
            return data[0]
        # linear interpolation between closest ranks
        pos = (q / 100.0) * (len(data) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(data) - 1)
        frac = pos - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    def _reset(self) -> None:
        self._bucket_counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._samples = []

    def _sample(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self._count, "sum": self._sum}
        if self._samples:
            out["p50"] = self.percentile(50)
            out["p95"] = self.percentile(95)
            out["p99"] = self.percentile(99)
        return out


def _label_pairs(labels: Optional[Mapping[str, str]]) -> LabelPairs:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(labels: LabelPairs) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + body + "}"


class MetricsRegistry:
    """Thread-safe instrument registry with pull collectors."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelPairs], _Instrument] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # -- registration --------------------------------------------------

    def _get(self, cls: type, name: str, help: str, unit: str,
             labels: Optional[Mapping[str, str]],
             **kwargs: Any) -> Any:
        key = (name, _label_pairs(labels))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.__name__.lower()}")
                return existing
            instrument = cls(self, name, help, unit, key[1], **kwargs)
            self._metrics[key] = instrument
            return instrument

    def counter(self, name: str, help: str = "", unit: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, unit, labels)

    def gauge(self, name: str, help: str = "", unit: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, unit, labels)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, help, unit, labels, buckets=buckets)

    def register_collector(
            self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register a pull hook run before every snapshot/exposition."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    # -- lifecycle -----------------------------------------------------

    def enable(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Zero all values; registrations and collectors survive."""
        with self._lock:
            for instrument in self._metrics.values():
                instrument._reset()  # type: ignore[attr-defined]

    # -- read side -----------------------------------------------------

    def _collect(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict dump: ``{name{labels}: {kind, unit, ...values}}``."""
        self._collect()
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._metrics.items())
        for (name, labels), instrument in sorted(items):
            entry = {"kind": instrument.kind, "unit": instrument.unit}
            entry.update(instrument._sample())  # type: ignore[attr-defined]
            out[name + _render_labels(labels)] = entry
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        self._collect()
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        seen_headers = set()
        for (name, labels), instrument in items:
            if name not in seen_headers:
                seen_headers.add(name)
                if instrument.help:
                    lines.append(f"# HELP {name} {instrument.help}")
                lines.append(f"# TYPE {name} {instrument.kind}")
            rendered = _render_labels(labels)
            if isinstance(instrument, Histogram):
                cumulative = 0
                for bound, n in zip(instrument.buckets,
                                    instrument._bucket_counts):
                    cumulative += n
                    le = _render_labels(labels + (("le", repr(bound)),))
                    lines.append(f"{name}_bucket{le} {cumulative}")
                le_inf = _render_labels(labels + (("le", "+Inf"),))
                lines.append(f"{name}_bucket{le_inf} {instrument._count}")
                lines.append(f"{name}_sum{rendered} {instrument._sum}")
                lines.append(f"{name}_count{rendered} {instrument._count}")
            else:
                lines.append(f"{name}{rendered} {instrument.value}")
        return "\n".join(lines) + ("\n" if lines else "")


# -- process-wide default registry ----------------------------------------

REGISTRY = MetricsRegistry(enabled=False)


def counter(name: str, help: str = "", unit: str = "",
            labels: Optional[Mapping[str, str]] = None) -> Counter:
    return REGISTRY.counter(name, help, unit, labels)


def gauge(name: str, help: str = "", unit: str = "",
          labels: Optional[Mapping[str, str]] = None) -> Gauge:
    return REGISTRY.gauge(name, help, unit, labels)


def histogram(name: str, help: str = "", unit: str = "",
              labels: Optional[Mapping[str, str]] = None,
              buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
    return REGISTRY.histogram(name, help, unit, labels, buckets=buckets)


def register_collector(fn: Callable[[MetricsRegistry], None]) -> None:
    REGISTRY.register_collector(fn)


def enable_metrics(enabled: bool = True) -> None:
    REGISTRY.enable(enabled)


def disable_metrics() -> None:
    REGISTRY.disable()


def metrics_enabled() -> bool:
    return REGISTRY.enabled


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def reset_metrics() -> None:
    REGISTRY.reset()


# -- ControllerRecord bridge ----------------------------------------------
# Duck-typed on repro.core.online.ControllerRecord so obs never imports the
# planner; FleetController.apply calls observe_controller_record per event
# and bridge_controller_log re-ingests historical logs for free.

def observe_controller_record(record: Any) -> None:
    """Publish one ControllerRecord's fields as metric samples."""
    if not REGISTRY.enabled:
        return
    histogram("repro_replan_latency_seconds",
              "Per-event controller replan latency.", unit="s",
              ).observe(float(record.replan_latency_s))
    counter("repro_controller_events_total",
            "Controller events applied, by kind.",
            labels={"kind": str(record.kind)}).inc()
    counter("repro_threads_migrated_total",
            "Threads moved between slots by replans.",
            ).inc(int(record.threads_migrated))
    counter("repro_slots_moved_total",
            "Slots whose VM assignment changed.").inc(int(record.slots_moved))
    gauge("repro_surface_passes_total",
          "Cumulative batched slot-surface computations.",
          ).set(int(record.batch_passes))
    gauge("repro_fleet_cost_per_hour",
          "Current fleet dollar cost per hour.", unit="$/h",
          ).set(float(record.fleet_cost_per_hour))
    drift_alerts = int(getattr(record, "drift_alerts", 0) or 0)
    if drift_alerts:
        counter("repro_drift_alerts_total",
                "DriftAlerts raised by the live fleet.").inc(drift_alerts)
    if getattr(record, "recalibrated", False):
        counter("repro_auto_recalibrations_total",
                "Automatic model recalibrations enacted.").inc()


def observe_execution_report(report: Any) -> None:
    """Publish one ExecutionReport's robustness counters as metrics."""
    if not REGISTRY.enabled:
        return
    counter("repro_frames_total",
            "Micro-batch frames processed by executors.",
            ).inc(int(report.frames))
    counter("repro_frames_shed_total",
            "Frames dropped by load shedding.").inc(int(report.frames_shed))
    counter("repro_frames_retried_total",
            "Operator invocations retried after transient errors.",
            ).inc(int(report.retries))
    counter("repro_frames_timed_out_total",
            "Frames killed by the frame-deadline watchdog.",
            ).inc(int(report.frames_timed_out))
    counter("repro_frames_failed_total",
            "Frames that lost tuples past retry.",
            ).inc(int(report.frames_failed))
    counter("repro_tuples_lost_total",
            "Tuples lost to failures and shedding.",
            ).inc(int(report.tuples_lost))
    histogram("repro_measured_latency_seconds",
              "Mean end-to-end frame latency per measurement window.",
              unit="s").observe(float(report.mean_latency))


def bridge_controller_log(log: Any) -> int:
    """Ingest every record of a ControllerLog; returns records bridged."""
    if not REGISTRY.enabled:
        return 0
    records = list(getattr(log, "records", log))
    for record in records:
        observe_controller_record(record)
    return len(records)
