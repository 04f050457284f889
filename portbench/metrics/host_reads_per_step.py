"""host_reads_per_step: the program's ``sync`` spans (a read from the
device, or a call that makes the host wait for the card) inside the
traced window's fits, over the steps those fits completed."""

from portbench import hostspans

hostspans.install()


def read(ctx):
    r = hostspans.read(ctx)
    if r is None or not ctx.steps:
        return None
    return r.sync_in_fits / ctx.steps
