"""Due time to first token, 90th percentile over every request due in the
window; a request with no first token counts as missing (host clock)."""

from perfbench import readers


def read(rd):
    return readers.p90_ms([readers.ttft(r) for r in rd.outcome.requests])
