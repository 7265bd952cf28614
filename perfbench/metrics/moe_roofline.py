"""The grouped expert kernels' share of their roofline over the traced
span: every MoE layer call's bound (``perfbench/work/hybrid_moe.py``
``moe_work``: FLOPs at the bf16 peak or bytes at the memory bandwidth,
the larger) summed over the span's prefills (each of its prompt's tokens)
and its decode ticks (one an engine step of the span, each over every
slot: the saturated loop decodes once a step), over the device time of
the operations named ``moe_grouped`` (``torch.profiler``).  A decode
tick's bytes count every expert that could be hit: a uniform router
leaves 4.6% of them without a row at 64 rows (``moe_work``), the cell's
router, its bias learned to balance the load, 5.4-5.5% (measured on the
card)."""

from perfbench import readers
from perfbench.work import hybrid_moe


def read(rd):
    o, s = rd.outcome, rd.cell.sizes
    if o.span is None or rd.peaks is None:
        return None
    t = o.span.device_seconds("moe_grouped")
    if t <= 0:
        return None
    layers = s["layer_pattern"].count("E")

    def bound(n):
        return layers * readers.bound_s(rd, *hybrid_moe.moe_work(s, n))
    ticks = o.notes.get("traced_steps") or rd.cell.mix["trace_steps"]
    total = sum(bound(S) for S in o.span_prefill_lens) \
        + ticks * bound(int(rd.cell.config["slots"]))
    return 100.0 * total / t
