"""Live micro-benchmark profiler (paper §5.1–5.2, RunTaskTrial).

Runs the 3-task trial DAG — source at constant rate ``omega`` -> the task
under test with ``tau`` threads on ONE resource slot -> sink — and measures
per-tuple latency, realized throughput and resource usage.  Stability is the
paper's latency-slope test.

Two runner flavours:

* :class:`LiveTrialRunner` — actually executes the operator callable on this
  host with a ``tau``-thread pool pinned to a one-core budget, timing real
  work (used for the compute-bound representative tasks).  Trials are kept
  short (hundreds of ms) so the full Alg. 1 sweep stays laptop-cheap.
* :class:`AnalyticTrialRunner` — closed-form contention model used for the
  external-service tasks (Azure Blob/Table have an SLA-bound curve that
  cannot be reproduced against live Azure from this container) and for fast
  deterministic tests.  Its curves follow Fig. 3's shapes.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .perfmodel import (ModelLibrary, PerfModel, TrialResult, build_perf_model,
                        latency_slope)
from ..obs import clock as _obs_clock


# ---------------------------------------------------------------------------
# Representative operator workloads (Table 1 analogues) as plain callables.
# The card-executed versions live in repro_torch.runtime.operators; these are the
# single-tuple Python bodies used for profiling trials.
# ---------------------------------------------------------------------------

def op_parse_xml(payload: str = "<r><a>1</a><b>2</b><c>3</c></r>" * 8) -> int:
    """CPU+memory heavy string parse (SAX-like single pass)."""
    depth = 0
    count = 0
    i = 0
    n = len(payload)
    while i < n:
        if payload[i] == "<":
            j = payload.index(">", i)
            tag = payload[i + 1:j]
            if tag.startswith("/"):
                depth -= 1
            else:
                depth += 1
                count += 1
            i = j + 1
        else:
            i += 1
    return count


def op_pi(iterations: int = 15) -> float:
    """Viete's infinite-product approximation of pi (fixed iterations)."""
    a = math.sqrt(2.0)
    prod = a / 2.0
    for _ in range(iterations - 1):
        a = math.sqrt(2.0 + a)
        prod *= a / 2.0
    return 2.0 / prod


class BatchFileWrite:
    """Accumulator: buffer strings, flush every ``window`` tuples."""

    def __init__(self, window: int = 100, path: Optional[str] = None):
        self.window = window
        self.buf: List[str] = []
        self.path = path
        self.flushes = 0

    def __call__(self, record: str = "x" * 100) -> int:
        self.buf.append(record)
        if len(self.buf) >= self.window:
            data = "".join(self.buf)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(data)
            self.buf.clear()
            self.flushes += 1
        return self.flushes


@dataclasses.dataclass
class ExternalService:
    """Latency-bound external dependency (Azure Blob/Table stand-in).

    ``base_latency`` is the per-request service time; ``sla_rate`` is the
    provider-side aggregate cap (requests/s) past which latency inflates —
    this produces the Fig. 3d/e bell curves.
    """

    base_latency: float
    sla_rate: float

    def latency_at(self, offered_rate: float) -> float:
        util = offered_rate / self.sla_rate
        if util < 1.0:
            return self.base_latency / max(1e-6, (1.0 - 0.5 * util))
        return self.base_latency * (1.0 + 4.0 * (util - 1.0) ** 2) * 2.0


AZURE_BLOB = ExternalService(base_latency=0.45, sla_rate=30.0)
AZURE_TABLE = ExternalService(base_latency=0.30, sla_rate=60.0)


# ---------------------------------------------------------------------------
# Live runner: real execution with a thread pool on a single-slot budget.
# ---------------------------------------------------------------------------

class LiveTrialRunner:
    """RunTaskTrial against a real Python callable.

    One trial admits tuples at rate ``omega`` for ``trial_seconds``; ``tau``
    worker threads drain a shared queue (Storm executor semantics).  Latency
    per tuple = completion - scheduled-arrival.  CPU% is estimated as
    busy-time / wall-time (capped at 1.0 = the slot's core); memory% uses a
    per-kind per-thread footprint estimate.

    Time is read through the shared telemetry clock seam
    (:mod:`repro_torch.obs.clock`) unless an explicit ``clock`` is passed.  Under
    a **virtual** clock the threaded wall-time trial makes no sense (real
    thread scheduling against frozen time is nondeterministic and all busy
    windows read as zero), so the runner switches to a deterministic
    discrete-event replay: ``tau`` servers, per-tuple ``service_time``
    (required in virtual mode), latencies computed in closed form and the
    clock advanced past the drain — identical results on every replay.
    """

    def __init__(self, make_op: Callable[[], Callable[[], object]],
                 *, trial_seconds: float = 0.4, mem_per_thread: float = 0.02,
                 mem_base: float = 0.02, clock: Optional[Any] = None,
                 service_time: Optional[float] = None):
        self.make_op = make_op
        self.trial_seconds = trial_seconds
        self.mem_per_thread = mem_per_thread
        self.mem_base = mem_base
        self.clock = clock             # None -> the repro_torch.obs.clock seam
        self.service_time = service_time   # priced tuple cost, virtual mode

    # -- clock plumbing --------------------------------------------------
    def _now(self) -> float:
        return _obs_clock.now() if self.clock is None else float(
            self.clock.now())

    def _sleep(self, seconds: float) -> None:
        if self.clock is None:
            _obs_clock.sleep(seconds)
        elif seconds > 0:
            self.clock.sleep(seconds)

    def _virtual(self) -> bool:
        if self.clock is None:
            return _obs_clock.is_virtual()
        return bool(getattr(self.clock, "virtual", False))

    def __call__(self, tau: int, omega: float) -> TrialResult:
        if self._virtual():
            return self._virtual_trial(tau, omega)
        return self._live_trial(tau, omega)

    # -- deterministic replay path (virtual clock) -----------------------
    def _virtual_trial(self, tau: int, omega: float) -> TrialResult:
        service = self.service_time
        if service is None or service <= 0:
            raise ValueError(
                "LiveTrialRunner under a virtual clock needs a positive "
                "service_time to price tuples (real thread timing is "
                "meaningless against frozen time)")
        start = self._now()
        n_tuples = max(4, int(omega * self.trial_seconds))
        interval = 1.0 / omega
        free = [start] * tau           # per-server next-available times
        heapq.heapify(free)
        lat: List[float] = []
        last_completion = start
        for i in range(n_tuples):
            arrival = start + i * interval
            begin = max(arrival, heapq.heappop(free))
            completion = begin + service
            heapq.heappush(free, completion)
            lat.append(completion - arrival)
            if completion > last_completion:
                last_completion = completion
        wall = max(last_completion, start + n_tuples * interval) - start
        self._sleep(wall)              # the trial occupies virtual time
        busy = n_tuples * service
        cpu = min(1.0, busy / max(wall, 1e-9))
        mem = self.mem_base + self.mem_per_thread * tau
        rate = n_tuples / max(wall, 1e-9)
        return TrialResult(cpu=cpu, mem=mem, latencies=lat,
                           supported_rate=rate)

    # -- real execution path (wall clock) --------------------------------
    def _live_trial(self, tau: int, omega: float) -> TrialResult:
        op = self.make_op()
        work_q: "queue_mod.Queue[Optional[float]]" = queue_mod.Queue()
        done: List[Tuple[float, float]] = []   # (arrival, completion)
        done_lock = threading.Lock()
        busy = [0.0] * tau
        stop = threading.Event()

        def worker(k: int) -> None:
            # hang protection: never block indefinitely on the queue (a
            # missed sentinel must not wedge the thread), honour the stop
            # event, and survive a raising operator (tuple counted lost)
            while not stop.is_set():
                try:
                    item = work_q.get(timeout=0.05)
                except queue_mod.Empty:
                    continue
                if item is None:
                    return
                t0 = self._now()
                try:
                    op()
                except Exception:
                    continue             # lost tuple: no completion record
                t1 = self._now()
                busy[k] += t1 - t0
                with done_lock:
                    done.append((item, t1))

        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(tau)]
        for t in threads:
            t.start()
        start = self._now()
        n_tuples = max(4, int(omega * self.trial_seconds))
        interval = 1.0 / omega
        for i in range(n_tuples):
            sched = start + i * interval
            now = self._now()
            if sched > now:
                self._sleep(sched - now)
            work_q.put(sched)
        # allow drain up to 2x trial time, then terminate
        deadline = self._now() + 2 * self.trial_seconds
        while not work_q.empty() and self._now() < deadline:
            self._sleep(0.005)
        for _ in threads:
            work_q.put(None)
        # hard deadline for teardown: a worker wedged inside op() cannot
        # hold the trial (or the tier-1 suite) hostage — stop the rest and
        # abandon the wedged daemon thread
        join_deadline = self._now() + max(1.0, self.trial_seconds)
        for t in threads:
            t.join(timeout=max(0.0, join_deadline - self._now()))
        stop.set()
        for t in threads:
            if t.is_alive():
                t.join(timeout=0.1)
        wall = self._now() - start
        with done_lock:
            lat = [c - a for a, c in sorted(done)]
        completed = len(lat)
        # undone tuples mean the config is grossly unstable: synthesize a
        # rising latency tail so the slope test rejects it.
        missing = n_tuples - completed
        if missing > 0:
            tail_base = (lat[-1] if lat else wall)
            lat.extend(tail_base + (k + 1) * interval for k in range(missing))
        cpu = min(1.0, sum(busy) / max(wall, 1e-9))
        mem = self.mem_base + self.mem_per_thread * tau
        rate = completed / max(wall, 1e-9)
        return TrialResult(cpu=cpu, mem=mem, latencies=lat, supported_rate=rate)


# ---------------------------------------------------------------------------
# Analytic runner: contention-model trials (deterministic, instantaneous).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ContentionProfile:
    """Closed-form single-slot contention model.

    * ``service_time``: per-tuple busy time of one thread (s)
    * ``ctx_overhead``: extra fractional cost per additional thread on the
      slot's one core (context switching, Fig. 3a's negative slope)
    * ``parallel_gain``: fraction of service time that is off-core waiting
      (I/O or external service) and therefore genuinely parallelizable —
      0.0 for Pi/ParseXML, ~1.0 for Blob/Table (the bell curves)
    * ``service``: optional SLA cap (the bell's eventual drop)
    * ``cpu_per_rate``/``mem_*``: resource accounting
    """

    service_time: float
    ctx_overhead: float = 0.02
    parallel_gain: float = 0.0
    service: Optional[ExternalService] = None
    cpu_base: float = 0.0
    cpu_per_busy: float = 1.0
    mem_base: float = 0.02
    mem_per_thread: float = 0.01

    def peak_rate(self, tau: int) -> float:
        on_core = self.service_time * (1.0 - self.parallel_gain)
        off_core = self.service_time * self.parallel_gain
        # One core serializes on-core work across threads and adds context
        # switch overhead; off-core time overlaps across threads.
        ctx = 1.0 + self.ctx_overhead * (tau - 1)
        per_thread = on_core * tau * ctx + off_core
        rate = tau / per_thread if per_thread > 0 else float("inf")
        if self.service is not None:
            rate = min(rate, self.service.sla_rate * min(
                1.0, tau * 1.0 / (self.service.sla_rate * self.service.base_latency)))
        return rate

    def trial(self, tau: int, omega: float) -> TrialResult:
        cap = self.peak_rate(tau)
        stable = omega <= cap
        base_lat = self.service_time + (self.service.base_latency
                                        if self.service else 0.0)
        n = 64
        if stable:
            util = omega / cap
            lat = [base_lat / max(1e-6, 1.0 - 0.9 * util)] * n
        else:
            # overloaded: queue grows by (omega - cap) tuples/s
            lat = [base_lat + k * (omega - cap) / max(cap, 1e-9) * 0.1
                   for k in range(n)]
        busy_frac = min(1.0, omega * self.service_time *
                        (1.0 - self.parallel_gain) * (1.0 + self.ctx_overhead * (tau - 1)))
        cpu = min(1.0, self.cpu_base + self.cpu_per_busy * busy_frac)
        mem = self.mem_base + self.mem_per_thread * tau
        return TrialResult(cpu=cpu, mem=mem, latencies=lat,
                           supported_rate=min(omega, cap))


#: Analytic profiles qualitatively matching Fig. 3 for the 5 representative
#: tasks (rates in the same order of magnitude as the paper's measurements).
ANALYTIC_PROFILES: Dict[str, ContentionProfile] = {
    "parse_xml": ContentionProfile(service_time=1 / 310.0, ctx_overhead=0.035,
                                   mem_base=0.20, mem_per_thread=0.02),
    "pi": ContentionProfile(service_time=1 / 105.0, ctx_overhead=0.02,
                            mem_base=0.02, mem_per_thread=0.01),
    "batch_file_write": ContentionProfile(service_time=1 / 60000.0,
                                          ctx_overhead=0.12, parallel_gain=0.1,
                                          mem_base=0.12, mem_per_thread=0.02),
    "azure_blob": ContentionProfile(service_time=0.01, parallel_gain=0.98,
                                    service=AZURE_BLOB, cpu_base=0.05,
                                    cpu_per_busy=0.8, mem_base=0.10,
                                    mem_per_thread=0.018),
    "azure_table": ContentionProfile(service_time=0.005, parallel_gain=0.985,
                                     service=AZURE_TABLE, cpu_base=0.02,
                                     cpu_per_busy=0.8, mem_base=0.03,
                                     mem_per_thread=0.011),
}


class AnalyticTrialRunner:
    def __init__(self, profile: ContentionProfile):
        self.profile = profile

    def __call__(self, tau: int, omega: float) -> TrialResult:
        return self.profile.trial(tau, omega)


def profile_task(kind: str, *, live: bool = False,
                 trial_seconds: float = 0.25, **alg1_kwargs) -> PerfModel:
    """Build a PerfModel for a representative task via Alg. 1."""
    if live:
        makers = {
            "parse_xml": lambda: op_parse_xml,
            "pi": lambda: op_pi,
            "batch_file_write": lambda: BatchFileWrite(),
        }
        if kind not in makers:
            raise ValueError(f"live profiling unsupported for {kind!r} "
                             "(external service); use analytic")
        runner = LiveTrialRunner(makers[kind], trial_seconds=trial_seconds)
        alg1_kwargs.setdefault("tau_max", 4)
        alg1_kwargs.setdefault("omega_start", 50.0)
        alg1_kwargs.setdefault("omega_max", 5e4)
    else:
        runner = AnalyticTrialRunner(ANALYTIC_PROFILES[kind])
        alg1_kwargs.setdefault("tau_max", 80)
    return build_perf_model(kind, runner, **alg1_kwargs)


def profiled_library(kinds: Sequence[str] = tuple(ANALYTIC_PROFILES),
                     *, live: bool = False, **kw) -> ModelLibrary:
    """Library of Alg.-1-built models (plus static source/sink)."""
    from .perfmodel import PAPER_MODELS
    lib = ModelLibrary({"source": PAPER_MODELS["source"],
                        "sink": PAPER_MODELS["sink"]})
    for kind in kinds:
        lib.add(profile_task(kind, live=live, **kw))
    return lib
