"""conv1x1_roofline (.r50), %: the bound of the window's conv1x1 launches
(the architecture's work.py: each operand read once, a stride-2 conv's
input only at the pixels it uses) over their device time by kernel name
(the .json beside: `_bn_kernel`, the tail of conv1x1_bn_kernel's name; no
other kernel of the cells that read this metric holds it), None unless the
program's launch counter agrees with the work counts (lib/counted.py)."""

from benchmark.lib import counted


def read(r):
    return counted.roofline_pct(r, __file__)
