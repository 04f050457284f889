"""Device time of the operations launched inside the program's spans of
given names, read from a traced window (:mod:`portbench.hostspans` records
the spans; the readers ``attn_ms_per_step`` and ``moe_ms_per_step``)."""

from __future__ import annotations

import bisect

from portbench import hostspans, tracing


def device_ms_per_step(ctx, names: tuple) -> float | None:
    """Σ device time of the window's operations whose launch lies inside a
    span named in ``names`` that opened inside a fit, in ms over the
    window's steps; None without a trace, the program's spans, or a span
    of those names."""
    spans = hostspans.recorded()
    tr = ctx.trace
    if tr is None or spans is None or not ctx.steps:
        return None
    fits = sorted(tr.fits)
    starts = [a for a, _b in fits]

    def in_fit(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= fits[i][1]
    mine = tracing.union([(s.start, s.end) for s in spans
                          if s.name in names and in_fit(s.start)])
    if not mine:
        return None
    lo = [a for a, _b in mine]
    dev_s = 0.0
    for o in tr.ops:
        i = bisect.bisect_right(lo, o.launch) - 1
        if i >= 0 and o.launch <= mine[i][1]:
            dev_s += o.end - o.start
    return 1e3 * dev_s / ctx.steps
