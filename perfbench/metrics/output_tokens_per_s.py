"""Every output token the engine emitted inside the window, over the
window (host clock)."""

from perfbench import reduce


def read(rd):
    return reduce.rate(rd.outcome.tokens, rd.outcome.window_s)
