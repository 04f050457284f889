"""row_roofline: the Row kernel's share of its roofline, in %: over the
traced window's fits, the sum of each Row launch's least time
(``portbench.work.bound_ms`` of its CPlan and operands) over the device
time of those launches (the kernel and its combine pass)."""

from portbench import rooflines


def read(ctx):
    return rooflines.share(ctx, "row")
