"""dispatch_ms_per_step: host ms of the fused regions' dispatch over the
steps of the traced window: the self time (duration less the part its
child spans cover) of every ``fused.call:*`` and ``fused.backward:*``
span inside the window's fits."""

from portbench import hostspans

hostspans.install()


def read(ctx):
    r = hostspans.read(ctx)
    if r is None or not ctx.steps:
        return None
    return 1e3 * r.dispatch_s / ctx.steps
