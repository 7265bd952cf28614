"""A traced span of engine steps, reduced in memory.

``torch.profiler`` records the device's operations and the host spans
that the harness opens with ``record_function`` (:data:`HOST_SPANS`)
over a fixed number of engine steps; no trace file is written.  The span
runs from the start of its first ``engine.step`` to the end of its last.
Its reduction: the union of the device's operations inside it (busy
seconds), the seconds of each operation by name, and the idle gaps
between operations, each put down to the innermost host span open at its
start (``harness`` where none is)."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from . import reduce

#: host spans the harness opens, outermost first
HOST_SPANS = ("engine.step", "model.prefill", "model.decode_step")
#: entries of each list of the result's ``breakdown``
TOP = 10


@dataclasses.dataclass
class SpanReading:
    window_s: float
    busy_s: float
    device_ops: Dict[str, float]      # seconds by operation name
    idle_by_host: Dict[str, float]    # idle seconds by host span
    kernels: int

    def device_seconds(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(s for n, s in self.device_ops.items()
                   if any(k in n for k in needles))

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


Interval = Tuple[float, float]


def _events(prof):
    """(device [(start, end, name)], host [(start, end, name)]) in
    seconds, from the profiler's raw results."""
    from torch.autograd import DeviceType
    dev, host = [], []
    try:
        raw = [(e.device_type(), e.name(), e.start_ns() * 1e-9,
                (e.start_ns() + e.duration_ns()) * 1e-9)
               for e in prof.profiler.kineto_results.events()]
    except AttributeError:       # an older profiler: its parsed events
        raw = [(e.device_type, e.name, e.time_range.start * 1e-6,
                e.time_range.end * 1e-6) for e in prof.events()]
    for kind, name, a, b in raw:
        # the device's copies of the host spans are not operations
        if kind == DeviceType.CUDA and name not in HOST_SPANS:
            dev.append((a, b, name))
        elif name in HOST_SPANS:
            host.append((a, b, name))
    return dev, host


def reduce_events(dev: List[Tuple[float, float, str]],
                  host: List[Tuple[float, float, str]]
                  ) -> Optional[SpanReading]:
    """The span's reading from device operations and host spans, each
    ``(start_s, end_s, name)``; None without an ``engine.step``."""
    steps = [(a, b) for a, b, n in host if n == "engine.step"]
    if not steps:
        return None
    lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
    inside = [(a, b, n) for a, b, n in dev if b > lo and a < hi]
    ops: Dict[str, float] = {}
    for a, b, n in inside:
        ops[n] = ops.get(n, 0.0) + (min(b, hi) - max(a, lo))
    busy = reduce.covered(reduce.clip([(a, b) for a, b, _ in inside], lo, hi))
    # innermost host span at a time: the deepest of HOST_SPANS open then
    by_depth = []
    for name in reversed(HOST_SPANS):
        ivs = sorted((a, b) for a, b, n in host if n == name)
        by_depth.append((name, [a for a, _ in ivs], ivs))

    def label(t: float) -> str:
        for name, starts, ivs in by_depth:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] > t:
                return name
        return "harness"
    idle: Dict[str, float] = {}
    for a, b in reduce.gaps([(a, b) for a, b, _ in inside], lo, hi):
        key = label(a)
        idle[key] = idle.get(key, 0.0) + (b - a)
    return SpanReading(window_s=hi - lo, busy_s=busy, device_ops=ops,
                       idle_by_host=idle, kernels=len(inside))


def warm(device) -> None:
    """Start and stop the profiler once over a tiny operation, so that its
    first start (CUPTI's set-up) falls in set-up, not in the span."""
    import torch
    p = Profiler()
    p.start()
    torch.ones(1, device=device).add_(1)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    p.stop()


class Profiler:
    """``start()`` before the span's first step, ``stop()`` after its
    last; ``reading()`` reduces what it recorded."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def reading(self) -> Optional[SpanReading]:
        return reduce_events(*_events(self._prof))
