"""plan_ms: host ms of the public planning calls (``<region>.trace(...)
.plan()``, its ``backward()``, ``core.codegen.compile_plan``) over the
cell's fused regions, from the process's empty plan cache, with the kernel
libraries already built: the planner's share of set-up."""


def read(ctx):
    return ctx.plan_ms
