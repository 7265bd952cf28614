"""The window's decode steps: their summed wall time (the engine's
``timings["decode"]``) over their number.  The traced span's steps are left
out: the profiler slows the host."""

from perfbench import readers


def read(rd):
    return readers.mean_ms(rd.outcome.decode_s)
