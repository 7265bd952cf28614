"""Model FLOPs of the window's prefills (``perfbench/work/<family>.py``
from each prompt's length) over their summed wall time (the engine's
timings), at the chip's bf16 peak: the whole prefill step's share of the
peak.  The traced span's prefills are left out: the profiler slows the
host."""

from perfbench import bench


def read(rd):
    o = rd.outcome
    secs = sum(o.prefill_s)
    if rd.peaks is None or not o.prefill_lens or secs <= 0:
        return None
    work = bench.load("work", rd.cell.config["family"])
    flops = sum(work.prefill_flops(rd.cell.sizes, S)
                for S in o.prefill_lens)
    return 100.0 * flops / (secs * rd.peaks["bf16_flops_per_s"])
