"""conv3x3_roofline (.bf16, .f32), %: the bound of the window's conv3x3
launches (the architecture's work.py: each operand read once, the TF32
split's three products per f32 product) over their device time by kernel
name (the .json beside)."""

from benchmark.lib import readers


def read(r):
    return readers.roofline_pct(r, __file__)
