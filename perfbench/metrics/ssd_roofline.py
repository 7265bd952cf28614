"""The SSD scan's share of its roofline over the traced span: the sum over
the span's prefills of every layer's scan's bound (``perfbench/work/
ssd.py``'s least FLOPs and bytes, bf16 inputs, no entering state) over
the device time of its three passes (``chunk_state``, ``state_scan``,
``chunk_out`` kernels; ``torch.profiler``)."""

from perfbench import readers
from perfbench.work import ssd


def read(rd):
    s = rd.cell.sizes
    H = s["ssm_expand"] * s["d_model"] // s["ssm_head_dim"]

    def per_prefill(S):
        fl, nb = ssd.work(1, S, H, s["ssm_head_dim"], s["ssm_state"],
                          s["ssm_chunk"], 2, False)
        return s["num_layers"] * readers.bound_s(rd, fl, nb)
    return readers.roofline_pct(
        rd, ("chunk_state", "state_scan_kernel", "chunk_out"), per_prefill)
