"""What the metric readers (``perfbench/metrics/<name>.py``) share.  Each
takes a ``bench.Reading`` and returns a number, or None where the run
holds nothing to read."""

from __future__ import annotations

import math
from typing import List, Optional

from . import bench, reduce


def p90_ms(values: List[float]) -> Optional[float]:
    """The 90th percentile in ms over every request, a missing one
    (``math.inf``) included; None where it lands on a missing one."""
    p = reduce.percentile(values, 90)
    return None if p is None or math.isinf(p) else p * 1e3


def ttft(r: bench.RequestRecord) -> float:
    return math.inf if r.first_token is None else r.first_token - r.due


def queue_wait(r: bench.RequestRecord) -> float:
    """Due time to the start of the request's prefill (its first token
    less the engine's time for that prefill)."""
    if r.first_token is None or r.prefill_s is None:
        return math.inf
    return r.first_token - r.prefill_s - r.due


def tpot(r: bench.RequestRecord) -> float:
    return (r.finished - r.first_token) / (r.n_out - 1)


def finished_in_window(rd: bench.Reading) -> List[bench.RequestRecord]:
    o = rd.outcome
    return [r for r in o.requests if r.finished is not None
            and r.finished <= o.window_s and r.n_out > 1]


def mean_ms(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) * 1e3 if values else None


def idle_pct(rd: bench.Reading) -> Optional[float]:
    s = rd.outcome.span
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def bound_s(rd: bench.Reading, flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    return max(flops / rd.peaks["bf16_flops_per_s"],
               nbytes / rd.peaks["hbm_bytes_per_s"])


def roofline_pct(rd: bench.Reading, needles, per_prefill) -> Optional[float]:
    """Sum over the span's prefills of ``per_prefill(S)`` (the bound of
    the kernel's calls in a prefill of ``S`` tokens) over the device time
    of the operations named by ``needles``, in percent."""
    o = rd.outcome
    if o.span is None or rd.peaks is None or not o.span_prefill_lens:
        return None
    t = o.span.device_seconds(*needles)
    if t <= 0:
        return None
    return 100.0 * sum(per_prefill(S) for S in o.span_prefill_lens) / t
