"""The program's own spans in a traced run, read beside the device trace.

The serving path opens ``repro_torch.obs`` spans: ``serve.*`` in the
engine, ``model.*`` and ``block.*`` in the model.  To record them on the
profiler's time base, :func:`install` puts a clock of Unix seconds (the
base of ``torch.profiler``'s event times) on the program's clock seam,
``repro_torch.obs.clock``, and a fresh enabled tracer in place of the
process's, once warm-up has cleared the engine's ``timings``;
:func:`restore` puts both back and returns the spans.  The engine's
``timings`` and its ``Request`` stamps stay on ``time.perf_counter``.
``perfbench/trace_probe.py`` does this around a run of a cell.

:func:`read` reduces the spans with the profiler's events:

* launches per span: the device operations (kernels, copies, fills)
  whose launch call, matched by the profiler's correlation id, the host
  made while a ``serve.prefill`` or ``serve.decode`` span of the traced
  span was open;
* idle by program span: each idle gap of the traced span, cut as
  ``profile_span`` cuts them, put down to the innermost program span open
  at its start, named by its path from ``serve.step``; where none is
  open, the harness's label;
* the clock check: the largest distance by which a ``serve.step`` lies
  outside the harness's ``engine.step`` around it, both as the profiler's
  clock puts them;
* the host's wait per decode: each ``serve.decode`` span's seconds and
  its ``serve.sample``'s (the host blocked on the chosen tokens), and its
  ``active`` slots, for the window's decode steps outside the traced
  span;
* the admissions: each ``serve.admit``'s ``prompt_len``, ``queued_s`` and
  seconds, for the window's prefills outside the traced span (the
  harness's ``lens`` capture, queue wait and ``timings["prefill"]``, read
  from the program).

A program without these spans (one older than them) records none; then
:func:`read` returns None.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import reduce
from .profile_span import HOST_SPANS

#: the prefix of every CUDA API call's name (``cudaLaunchKernel``,
#: ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...), among the profiler's host events
LAUNCH_PREFIX = "cu"
#: the program spans whose launches are counted
COUNTED = ("serve.prefill", "serve.decode")

Span = Tuple[float, float, str]                 # (start_s, end_s, name)
DeviceOp = Tuple[float, float, str, int]        # (start_s, end_s, name, correlation id)
Admit = Tuple[int, float, float]                # (prompt_len, queued_s, seconds)
Marks = Dict[str, int]                          # the runner's step marks


class UnixClock:
    """Seconds since the Unix epoch: the profiler's time base."""

    def now(self) -> float:
        return time.time_ns() * 1e-9


def install():
    """Record the program's spans on the profiler's clock from now on;
    returns what :func:`restore` needs."""
    from repro_torch import obs
    tracer = obs.Tracer(enabled=True)
    return tracer, obs.set_tracer(tracer), obs.clock.set_clock(UnixClock())


def restore(installed) -> List[Any]:
    """Put back the tracer and clock that :func:`install` replaced;
    returns the spans recorded meanwhile (``obs.SpanRecord``)."""
    from repro_torch import obs
    tracer, tracer0, clock0 = installed
    obs.set_tracer(tracer0)
    obs.clock.set_clock(clock0)
    return tracer.spans


def intervals(records: Sequence[Any]) -> List[Span]:
    """``(start_s, end_s, name)`` of each span record."""
    return [(r.t0, r.t1, r.name) for r in records]


@dataclasses.dataclass
class ProgramReading:
    launches: Dict[str, List[int]]      # COUNTED name -> per span, in order
    idle_by_span: Dict[str, float]      # idle seconds by label
    clock_residual_us: Optional[float]
    decode: List[Tuple[float, float]]   # (serve.decode s, serve.sample s)
    active: List[int] = dataclasses.field(default_factory=list)  # a decode's slots
    admits: List[Admit] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0
    unmatched: int = 0                  # device operations with no launch

    def idle_list(self) -> List[List]:
        return [[n, s] for n, s in
                sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])]

    def mean_launches(self, name: str) -> Optional[float]:
        """Mean launches of the traced span's ``name`` spans."""
        counts = self.launches.get(name)
        return sum(counts) / len(counts) if counts else None

    def decode_wait_pct(self) -> Optional[float]:
        """The host's wait for the chosen tokens (``serve.sample``) over
        the decode steps' seconds (``serve.decode``), summed over the
        steps read, in percent."""
        total = sum(d for d, _ in self.decode)
        return (100.0 * sum(s for _, s in self.decode) / total
                if total > 0 else None)

    def mean_active(self) -> Optional[float]:
        """Slots decoding, mean over the decode steps read."""
        return sum(self.active) / len(self.active) if self.active else None

    def queue_wait_p90_ms(self) -> Optional[float]:
        """``submit`` to admission, 90th percentile over the admissions
        read, in ms."""
        p = reduce.percentile([q for _, q, _ in self.admits], 90)
        return None if p is None else p * 1e3

    def prefill_ms_per_ktoken(self) -> Optional[float]:
        """The admissions' seconds over their prompt tokens, in ms per
        1000 tokens."""
        tokens = sum(n for n, _, _ in self.admits)
        return (sum(s for _, _, s in self.admits) / tokens * 1e6
                if tokens else None)


def profiler_events(prof):
    """(device operations, the harness's host spans, launch call start by
    correlation id) from a ``profile_span.Profiler``; raises where the
    profiler's raw events cannot be read, rather than read no launch."""
    from torch.autograd import DeviceType
    try:
        events = prof._prof.profiler.kineto_results.events()
    except AttributeError as e:
        raise RuntimeError("program_trace: this torch.profiler keeps no raw "
                           "events (kineto_results) to read launches from"
                           ) from e
    dev: List[DeviceOp] = []
    host: List[Span] = []
    launch: Dict[int, float] = {}
    for e in events:
        name, a = e.name(), e.start_ns() * 1e-9
        b = (e.start_ns() + e.duration_ns()) * 1e-9
        if e.device_type() == DeviceType.CUDA:
            # the device's copies of the host spans are not operations
            if name not in HOST_SPANS:
                dev.append((a, b, name, e.correlation_id()))
        elif name in HOST_SPANS:
            host.append((a, b, name))
        elif name.startswith(LAUNCH_PREFIX):
            c = e.correlation_id()
            launch[c] = min(a, launch.get(c, a))
    return dev, host, launch


def nest(spans: Sequence[Span]) -> List[Tuple[float, float, str, int]]:
    """Each span with its path from the outermost span around it
    (``serve.step/serve.decode/block.ssm``) and its depth."""
    out, stack = [], []
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            stack.pop()
        path = f"{stack[-1][2]}/{name}" if stack else name
        stack.append((a, b, path))
        out.append((a, b, path, len(stack) - 1))
    return out


def innermost(spans: Sequence[Span]):
    """``label(t)``: the path of the innermost span open at ``t``, or
    None."""
    levels: Dict[int, List[Tuple[float, float, str]]] = {}
    for a, b, path, depth in nest(spans):
        levels.setdefault(depth, []).append((a, b, path))
    by_depth = [(([a for a, _, _ in ivs]), ivs)
                for _, ivs in sorted(levels.items(), reverse=True)]

    def label(t: float) -> Optional[str]:
        for starts, ivs in by_depth:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] > t:
                return ivs[i][2]
        return None
    return label


def window(host: Sequence[Span], spans: Sequence[Span],
           launch: Dict[int, float]) -> Optional[Tuple[float, float]]:
    """The traced span: from the start of its first ``engine.step`` to the
    end of its last, or, where the profiler recorded no host spans, the
    ``serve.step`` spans during which it saw a launch."""
    steps = [(a, b) for a, b, n in host if n == "engine.step"]
    if not steps:
        times = sorted(launch.values())
        steps = [(a, b) for a, b, n in spans if n == "serve.step" and
                 bisect.bisect_left(times, a) < bisect.bisect_right(times, b)]
    if not steps:
        return None
    return min(a for a, _ in steps), max(b for _, b in steps)


def idle_by_span(dev: Sequence[DeviceOp], host: Sequence[Span],
                 spans: Sequence[Span], lo: float, hi: float
                 ) -> Dict[str, float]:
    """Idle seconds of ``[lo, hi]`` (no device operation running) by the
    innermost program span open at each gap's start; where none is, the
    innermost harness span (``profile_span.HOST_SPANS``), else
    ``harness``."""
    program, harness = innermost(spans), innermost(host)
    out: Dict[str, float] = {}
    for a, b in reduce.gaps([(a, b) for a, b, _, _ in dev], lo, hi):
        key = program(a) or (harness(a) or "harness").rsplit("/", 1)[-1]
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def launch_counts(dev: Sequence[DeviceOp], launch: Dict[int, float],
                  spans: Sequence[Span], lo: float, hi: float
                  ) -> Tuple[Dict[str, List[int]], int]:
    """For each ``COUNTED`` span starting inside ``[lo, hi]``, in order,
    the device operations whose launch call it holds; and how many
    device operations have no launch call recorded."""
    times, unmatched = [], 0
    for _, _, _, corr in dev:
        t = launch.get(corr)
        if t is None:
            unmatched += 1
        else:
            times.append(t)
    times.sort()
    out: Dict[str, List[int]] = {n: [] for n in COUNTED}
    for a, b, name in sorted(spans):
        if name in out and lo <= a < hi:
            out[name].append(bisect.bisect_right(times, b)
                             - bisect.bisect_left(times, a))
    return out, unmatched


def clock_residual_s(host: Sequence[Span], spans: Sequence[Span]
                     ) -> Optional[float]:
    """The largest distance by which a ``serve.step`` lies outside the
    ``engine.step`` whose start is nearest its own; None without both."""
    steps = sorted((a, b) for a, b, n in spans if n == "serve.step")
    starts = [a for a, _ in steps]
    worst = None
    for a, b, n in host:
        if n != "engine.step" or not steps:
            continue
        i = bisect.bisect_left(starts, a)
        j = min((k for k in (i - 1, i) if 0 <= k < len(steps)),
                key=lambda k: abs(starts[k] - a))
        t0, t1 = steps[j]
        off = max(0.0, a - t0, t1 - b)
        worst = off if worst is None else max(worst, off)
    return worst


def decode_steps(spans: Sequence[Span]) -> List[Tuple[float, float]]:
    """Each ``serve.decode`` span's seconds and those of the
    ``serve.sample`` inside it, in order."""
    decodes = sorted((a, b) for a, b, n in spans if n == "serve.decode")
    samples = sorted((a, b) for a, b, n in spans if n == "serve.sample")
    starts = [a for a, _ in samples]
    out = []
    for a, b in decodes:
        i = bisect.bisect_left(starts, a)
        inside = i < len(samples) and samples[i][1] <= b
        out.append((b - a, samples[i][1] - samples[i][0] if inside else 0.0))
    return out


def attributes(records: Sequence[Any], name: str) -> List[Tuple[Any, Dict]]:
    """Each ``name`` span record, in order, with its attributes."""
    return [(r, r.attr_dict()) for r in
            sorted((r for r in records if r.name == name), key=lambda r: r.t0)]


def in_cuts(xs: Sequence, cuts: Sequence[Tuple[Marks, Marks]], key: str
            ) -> List:
    """The entries of ``xs`` whose indices fall in the cuts' ``key``
    ranges, in order."""
    return [xs[k] for lo, hi in cuts for k in range(lo[key], min(hi[key],
                                                                 len(xs)))]


def read(prof, records: Sequence[Any], cuts: Sequence[Tuple[Marks, Marks]]
         ) -> Optional[ProgramReading]:
    """The program's reading of a traced run.  ``prof``: the traced span's
    ``profile_span.Profiler`` (None: no span was traced); ``records``: the
    spans from :func:`restore`, installed when the engine's ``timings``
    were empty, so that the k-th ``serve.decode`` is
    ``timings["decode"][k]`` and the k-th ``serve.admit``
    ``timings["prefill"][k]``; ``cuts``: pairs of the runner's marks
    (``prefill`` and ``decode`` indices) to read the decode steps and
    admissions over.  None where the program opened no ``serve.step``."""
    spans = intervals(records)
    if not any(n == "serve.step" for _, _, n in spans):
        return None
    got = ProgramReading(
        {n: [] for n in COUNTED}, {}, None,
        decode=in_cuts(decode_steps(spans), cuts, "decode"),
        active=in_cuts([a["active"] for _, a in
                        attributes(records, "serve.decode")], cuts, "decode"),
        admits=in_cuts([(a["prompt_len"], a["queued_s"], r.duration)
                        for r, a in attributes(records, "serve.admit")],
                       cuts, "prefill"))
    if prof is None:
        return got
    dev, host, launch = profiler_events(prof)
    residual = clock_residual_s(host, spans)
    got.clock_residual_us = None if residual is None else residual * 1e6
    span = window(host, spans, launch)
    if span is None:
        return got
    lo, hi = span
    got.window_s = hi - lo
    got.busy_s = reduce.covered(reduce.clip([(a, b) for a, b, _, _ in dev],
                                            lo, hi))
    got.idle_by_span = idle_by_span(dev, host, spans, lo, hi)
    got.launches, got.unmatched = launch_counts(dev, launch, spans, lo, hi)
    return got
