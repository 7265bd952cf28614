"""Shared observability clock seam.

Every timestamp the telemetry layer records — span start/stop, metric
sample times, profiler trial durations — is read through this module so
that installing a :class:`repro.runtime.stream.VirtualClock` makes the
whole telemetry surface bit-deterministic under a chaos seed.

The seam is deliberately tiny: a process-wide slot holding either
``None`` (wall time via ``time.perf_counter``) or any object exposing
``.now() -> float`` (and optionally ``.sleep(s)`` / ``.virtual``).
``LiveFleet.apply`` installs its own clock for the duration of each
tick; callers that want explicit scoping use :func:`use_clock`.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Optional

__all__ = [
    "now", "sleep", "is_virtual", "get_clock", "set_clock", "use_clock",
]

_LOCK = threading.Lock()
_CLOCK: Optional[Any] = None  # None -> wall clock (time.perf_counter)


def now() -> float:
    """Current time in seconds from the installed clock (wall by default)."""
    clock = _CLOCK
    return time.perf_counter() if clock is None else float(clock.now())


def sleep(seconds: float) -> None:
    """Sleep on the installed clock; virtual clocks advance instantly."""
    clock = _CLOCK
    if clock is None:
        if seconds > 0:
            time.sleep(seconds)
    else:
        clock.sleep(seconds)


def is_virtual() -> bool:
    """True when the installed clock declares itself virtual."""
    return bool(getattr(_CLOCK, "virtual", False))


def get_clock() -> Optional[Any]:
    """The currently installed clock object, or ``None`` for wall time."""
    return _CLOCK


def set_clock(clock: Optional[Any]) -> Optional[Any]:
    """Install ``clock`` (or ``None`` for wall time); returns the previous."""
    global _CLOCK
    with _LOCK:
        previous = _CLOCK
        _CLOCK = clock
    return previous


@contextmanager
def use_clock(clock: Optional[Any]) -> Iterator[Optional[Any]]:
    """Scoped :func:`set_clock`: restores the previous clock on exit."""
    previous = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(previous)
