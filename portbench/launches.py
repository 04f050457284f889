"""Which generated kernel each of a fit's fused operators launched, and
its least time.

One fit of set-up runs under a profile hook (on every thread) that
watches the port's public dispatch, ``repro_torch.kernels.ops.execute(
cplan, env, ...)``: at each call it keeps its first two arguments, the
CPlan and its operands, at the return the output, and the program's own
launch counters before and after tell which template launched.  The least
time is :func:`portbench.work.bound_ms` of that CPlan over those operands,
for every template; None where that arithmetic does not apply to the
launch (it raises).  Nothing of the program is changed; the hook is off
before the measured window opens.
"""

from __future__ import annotations

import threading

from portbench import work


def record(fn):
    """Run ``fn()`` once under the hook; returns (its result, [(template,
    least ms or None)] in launch order)."""
    from repro_torch.kernels import cellwise, multiagg, ops, outerprod, \
        rowwise
    counters = {"row": rowwise, "cell": cellwise, "magg": multiagg,
                "outer": outerprod}
    code = ops.execute.__code__
    cplan_arg, env_arg = code.co_varnames[:2]
    pending: dict[int, tuple] = {}
    seq: list[tuple[str, float | None]] = []

    def hook(frame, event, arg):
        if frame.f_code is not code:
            return
        if event == "call":
            loc = frame.f_locals
            pending[id(frame)] = (loc[cplan_arg], dict(loc[env_arg]),
                                  {k: m.launches for k, m in counters.items()})
        elif event == "return" and id(frame) in pending:
            cplan, env, before = pending.pop(id(frame))
            launched = [k for k, m in counters.items()
                        if m.launches != before[k]]
            if len(launched) == 1:
                seq.append((launched[0], _least(cplan, env, arg)))

    # the backward runs on autograd's device thread: watch every thread
    threading.setprofile_all_threads(hook)
    try:
        out = fn()
    finally:
        threading.setprofile_all_threads(None)
    return out, seq


def _least(cplan, env, out):
    try:
        return work.bound_ms(cplan, env, out)[0]
    except Exception:          # noqa: BLE001 - not this arithmetic's launch
        return None
