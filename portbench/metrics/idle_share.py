"""idle_share: the share of the traced window, in %, that no device
operation covers (the union of the operations' intervals is the busy
time)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
