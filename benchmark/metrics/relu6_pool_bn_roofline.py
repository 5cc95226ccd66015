"""relu6_pool_bn_roofline (.bf16, .f32), %: the bound of the window's
relu6_pool_bn launches (the architecture's work.py: the rows and columns
some window covers read once, the output written once) over their device
time by kernel name (the .json beside)."""

from benchmark.lib import readers


def read(r):
    return readers.roofline_pct(r, __file__)
