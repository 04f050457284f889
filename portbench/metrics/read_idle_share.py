"""read_idle_share: the share of the traced window, in %, that the device
sat idle after the program's reads: in each idle gap, the time from the
end of the first ``sync`` span ending in it to the next device
operation's start."""

from portbench import hostspans

hostspans.install()


def read(ctx):
    r = hostspans.read(ctx)
    tr = ctx.trace
    if r is None or tr.window_s <= 0:
        return None
    return 100.0 * r.read_idle_s / tr.window_s
