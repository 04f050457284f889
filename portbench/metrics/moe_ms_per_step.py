"""moe_ms_per_step: device ms a step of the operations launched inside the
program's ``moe`` spans (an expert layer's forward, and its backward
between the gradient hooks at its output and input), over the steps of
the traced window's fits."""

from portbench import hostspans, lmspans

hostspans.install()


def read(ctx):
    return lmspans.device_ms_per_step(ctx, ("moe",))
