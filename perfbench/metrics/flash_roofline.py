"""The flash kernel's share of its roofline over the traced span: the sum
over the span's prefills of every layer's causal call's bound
(``perfbench/work/flash.py``: FLOPs at the bf16 peak or bytes at the
memory bandwidth, the larger) over the device time of the operations
named ``flash_fwd`` (``torch.profiler``)."""

from perfbench import readers
from perfbench.work import flash


def read(rd):
    s = rd.cell.sizes

    def per_prefill(S):
        fl, nb = flash.work(1, S, S, s["num_heads"], s["num_kv_heads"],
                            s["head_dim"], 2)
        return s["num_layers"] * readers.bound_s(rd, fl, nb)
    return readers.roofline_pct(rd, ("flash_fwd",), per_prefill)
