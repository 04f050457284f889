"""step_mfu: a step's least time over its measured time, in %.  The least
time of a fit is the larger of its main operand read once a step over HBM
and the fp32 operations of its products over it (``portbench.work``, a
fixed formula of the shapes and iteration counts); the measured time is the
traced window's host-clock length.  Every fit of the window is counted."""


def read(ctx):
    if not ctx.fits or ctx.window_s <= 0:
        return None
    return 100.0 * len(ctx.fits) * ctx.fit_least_ms / (ctx.window_s * 1e3)
