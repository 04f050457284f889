"""outer_roofline: the Outer kernel's share of its roofline over BCSR, in
%: over the traced window's fits, the sum of each Outer launch's least time
(``portbench.work.outer_bound_ms``, stored blocks only) over the device
time of those launches (the kernel and its fold pass)."""

from portbench import rooflines


def read(ctx):
    return rooflines.share(ctx, "outer")
