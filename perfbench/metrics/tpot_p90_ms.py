"""(last token - first token) / (tokens - 1), 90th percentile over every
request finished in the window (host clock)."""

from perfbench import readers


def read(rd):
    done = readers.finished_in_window(rd)
    return readers.p90_ms([readers.tpot(r) for r in done]) if done else None
