"""Process start to the first due request: imports, CUDA's start, weights,
cache, warm-up (host clock)."""


def read(rd):
    return rd.outcome.setup_s
