"""1 - the union of the device's operations over the traced span's wall
time (``torch.profiler``), in percent."""

from perfbench import readers


def read(rd):
    return readers.idle_pct(rd)
