"""device_idle_pct (.bf16, .f32): the share of the traced window in which no
operation ran on the device (1 - the union of the device operations'
intervals over the window, torch.profiler)."""

from benchmark.lib import readers


def read(r):
    return readers.idle_pct(r)
