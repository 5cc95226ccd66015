"""conv3x3_roofline.r50, %: the bound of the window's conv3x3 launches (the
architecture's work.py: each operand read once) over their device time by
kernel name (the .json beside: the streamed path's conv_wg_stream, and
conv_wg, whose name holds both), None unless the program's launch counter
agrees with the work counts (lib/counted.py)."""

from benchmark.lib import counted


def read(r):
    return counted.roofline_pct(r, __file__)
