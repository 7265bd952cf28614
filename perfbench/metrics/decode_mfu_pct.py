"""The whole decode step's share of its roofline: its least time
(``perfbench/work/hybrid_moe.py`` ``decode_work``: model FLOPs at the
bf16 peak or least bytes at the memory bandwidth, the larger, over every
slot and the cache's positions) over the window's mean decode step (the
engine's timings, the traced span's steps left out)."""

from perfbench import readers
from perfbench.work import hybrid_moe


def read(rd):
    o, cell = rd.outcome, rd.cell
    if rd.peaks is None or not o.decode_s:
        return None
    positions = int(cell.mix["prompt"]["max"]) + int(cell.mix["output"]["max"]) + 8
    least = readers.bound_s(rd, *hybrid_moe.decode_work(
        cell.sizes, int(cell.config["slots"]), positions))
    return 100.0 * least / (sum(o.decode_s) / len(o.decode_s))
