"""A generated kernel's share of its roofline over the traced window."""

from __future__ import annotations

import sys

from portbench import tracing


def share(ctx, template: str):
    """Σ least time / Σ device time, in %, of the ``template`` launches
    (each with its second pass) of the traced window's fits.  The least
    times are those of the set-up fit recorded by
    :mod:`portbench.launches`, launch by launch; a fit of the window that
    launched another count of ``template`` kernels (a loop that stopped
    early) is left out, and the share is unread where no fit is left or a
    least time is unknown."""
    per_fit = [least for t, least in ctx.launch_seq if t == template]
    if ctx.trace is None or not per_fit or None in per_fit:
        return None
    least_ms = dev_s = 0.0
    counts = []
    for ops in tracing.ops_by_fit(ctx.trace):
        mine = [o for o in ops if o.template == template]
        counts.append(sum(o.first_pass for o in mine))
        if counts[-1] == len(per_fit):
            least_ms += sum(per_fit)
            dev_s += sum(o.end - o.start for o in mine)
    left_out = [c for c in counts if c != len(per_fit)]
    if left_out:
        print(f"[portbench] {template}_roofline: {len(left_out)} of "
              f"{len(counts)} fits left out, launching {left_out} "
              f"{template} kernels against {len(per_fit)} in set-up",
              file=sys.stderr)
    if dev_s <= 0:
        return None
    return 100.0 * least_ms / (dev_s * 1e3)
