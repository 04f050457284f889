"""launches_per_step: device kernel launches in the traced window
(generated, library and torch's own; no copies or memsets) over the steps
its fits completed."""


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    return sum(op.kernel for op in ctx.trace.ops) / ctx.steps
