"""Share of the window that the engine spent in prefills (the sum of its
``timings["prefill"]``), during which no slot decodes.  The traced span
is left out of both: the profiler slows the host."""


def read(rd):
    o = rd.outcome
    if o.untraced_s <= 0:
        return None
    return 100.0 * sum(o.prefill_s) / o.untraced_s
