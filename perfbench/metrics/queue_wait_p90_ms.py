"""Due time to the start of the request's prefill, 90th percentile over
every request due in the window (the engine's ``timings["prefill"]``, in
admission order, taken from its first token).  In the traced run only the
requests due before the traced span began count: the profiler slows the
host, and the queue it builds lasts past the span."""

from perfbench import readers


def read(rd):
    o = rd.outcome
    reqs = [r for r in o.requests if o.span_at is None or r.due < o.span_at]
    return readers.p90_ms([readers.queue_wait(r) for r in reqs])
