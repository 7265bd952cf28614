"""Deterministic span tracing.

A :class:`Tracer` records closed spans ``(name, t0, t1, depth, attrs)``
with timestamps read through :mod:`repro_torch.obs.clock`, so a trace captured
under a :class:`~repro.runtime.stream.VirtualClock` is bit-deterministic
for a given chaos seed: :meth:`Tracer.signature` over two replays of the
same seed compares equal.

Tracing is off by default.  The module-level :func:`span` entry point is
the instrumentation hook used throughout the planner/controller/runtime;
when the tracer is disabled it returns a shared no-op span object without
touching any lock, so dormant instrumentation costs one attribute check
per call site.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, TypeVar

from . import clock as _clock

__all__ = [
    "SpanRecord", "Tracer", "span", "trace", "get_tracer", "set_tracer",
    "enable_tracing", "disable_tracing", "tracing_enabled",
]

_F = TypeVar("_F", bound=Callable[..., Any])


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span: a named interval with static attributes."""

    name: str
    t0: float
    t1: float
    depth: int          # nesting depth within the opening thread (0 = root)
    thread: int         # stable per-tracer thread ordinal (0 = first seen)
    attrs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def attr_dict(self) -> Dict[str, Any]:
        return dict(self.attrs)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "t0": self.t0, "t1": self.t1,
            "depth": self.depth, "thread": self.thread,
            "attrs": self.attr_dict(),
        }

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "SpanRecord":
        return SpanRecord(
            name=str(obj["name"]), t0=float(obj["t0"]), t1=float(obj["t1"]),
            depth=int(obj.get("depth", 0)), thread=int(obj.get("thread", 0)),
            attrs=tuple(sorted(dict(obj.get("attrs", {})).items())),
        )


class _NullSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span; closing it appends a :class:`SpanRecord` to the tracer."""

    __slots__ = ("_tracer", "name", "_attrs", "_t0", "_depth", "_closed")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self._attrs = attrs
        self._t0 = 0.0
        self._depth = 0
        self._closed = False

    def set(self, **attrs: Any) -> "_Span":
        """Attach attributes after opening (e.g. results known at close)."""
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._depth = self._tracer._push(self.name)
        self._t0 = _clock.now()
        return self

    def __exit__(self, *exc: Any) -> None:
        t1 = _clock.now()
        self._closed = True
        self._tracer._pop(self, t1)
        return None


class Tracer:
    """Thread-safe recorder of closed spans.

    ``enabled`` gates recording; flipping it mid-run is safe (spans opened
    while enabled still close normally).  Open spans are tracked per
    thread so :meth:`open_spans` — and the ``OBS_SPAN_UNCLOSED`` verifier
    built on it — can detect instrumentation that leaked a span.
    """

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self._local = threading.local()
        self._thread_ids: Dict[int, int] = {}

    # -- span lifecycle ------------------------------------------------

    def span(self, name: str, **attrs: Any) -> Any:
        """Open a span context manager (no-op object when disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def trace(self, name: Optional[str] = None) -> Callable[[_F], _F]:
        """Decorator form: ``@tracer.trace("plan")``."""
        def deco(fn: _F) -> _F:
            label = name or fn.__qualname__

            def wrapper(*args: Any, **kwargs: Any) -> Any:
                with self.span(label):
                    return fn(*args, **kwargs)

            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__wrapped__ = fn  # type: ignore[attr-defined]
            return wrapper  # type: ignore[return-value]
        return deco

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _push(self, name: str) -> int:
        stack = self._stack()
        depth = len(stack)
        stack.append(name)
        return depth

    def _pop(self, live: _Span, t1: float) -> None:
        stack = self._stack()
        if stack and stack[-1] == live.name:
            stack.pop()
        elif live.name in stack:  # tolerate out-of-order exits
            stack.remove(live.name)
        ident = threading.get_ident()
        attrs = tuple(sorted(live._attrs.items()))
        with self._lock:
            ordinal = self._thread_ids.setdefault(ident, len(self._thread_ids))
            self._spans.append(SpanRecord(
                name=live.name, t0=live._t0, t1=t1,
                depth=live._depth, thread=ordinal, attrs=attrs))

    # -- inspection ----------------------------------------------------

    @property
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def open_spans(self) -> List[str]:
        """Names of spans opened on *this* thread but never closed."""
        return list(self._stack())

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._thread_ids.clear()
        self._local = threading.local()

    def signature(self) -> Tuple[Tuple[str, float, float, int, int,
                                       Tuple[Tuple[str, Any], ...]], ...]:
        """Hashable fingerprint of the full span timeline.

        Under a virtual clock two replays of the same chaos seed produce
        *equal* signatures — the determinism pin mirrors
        ``FaultTimeline.signature()``.
        """
        return tuple((s.name, s.t0, s.t1, s.depth, s.thread, s.attrs)
                     for s in self.spans)

    # -- export --------------------------------------------------------

    def to_jsonl(self) -> str:
        """One JSON object per line, one line per closed span."""
        return "\n".join(json.dumps(s.to_json(), sort_keys=True)
                         for s in self.spans)

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome/Perfetto ``trace_event`` JSON (complete ``"X"`` events)."""
        return spans_to_chrome(self.spans)


def spans_to_chrome(spans: Iterable[SpanRecord]) -> Dict[str, Any]:
    """Convert span records to the Chrome ``trace_event`` JSON format.

    Timestamps and durations are microseconds; open the output at
    https://ui.perfetto.dev or chrome://tracing.
    """
    events: List[Dict[str, Any]] = []
    for s in spans:
        events.append({
            "name": s.name, "ph": "X", "pid": 0, "tid": s.thread,
            "ts": round(s.t0 * 1e6, 3),
            "dur": round(max(0.0, s.duration) * 1e6, 3),
            "args": s.attr_dict(),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_from_jsonl(text: str) -> List[SpanRecord]:
    """Parse :meth:`Tracer.to_jsonl` output back into records."""
    out: List[SpanRecord] = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            out.append(SpanRecord.from_json(json.loads(line)))
    return out


# -- process-wide default tracer ------------------------------------------

_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process tracer (tests); returns the previous one."""
    global _TRACER
    previous = _TRACER
    _TRACER = tracer
    return previous


def span(name: str, **attrs: Any) -> Any:
    """Open a span on the process tracer — the instrumentation hook.

    When tracing is disabled this returns a shared no-op object: no
    allocation beyond the kwargs dict, no lock taken.
    """
    tracer = _TRACER
    if not tracer.enabled:
        return _NULL_SPAN
    return _Span(tracer, name, attrs)


def trace(name: Optional[str] = None) -> Callable[[_F], _F]:
    """Decorator tracing a function on the process tracer."""
    def deco(fn: _F) -> _F:
        label = name or fn.__qualname__

        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with span(label):
                return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn  # type: ignore[attr-defined]
        return wrapper  # type: ignore[return-value]
    return deco


def enable_tracing(enabled: bool = True) -> None:
    _TRACER.enabled = bool(enabled)


def disable_tracing() -> None:
    _TRACER.enabled = False


def tracing_enabled() -> bool:
    return _TRACER.enabled
