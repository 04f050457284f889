"""From a ``torch.profiler`` trace of the measured window to what the
per-layer readers read: the device operations in the window, the busy time
(the union of the operations' intervals) and the idle gaps.

The profiler records the device's activity alone (kernels, copies and the
CUDA runtime calls that launched them), not the host's operators, so that
it adds little to a fit's host time.  The benchmark's own spans, the
window and each fit in it, are host-clock readings handed in beside the
trace, moved onto its clock (the Unix clock, ``time.time_ns``) by
:func:`to_trace_clock`.  Times are seconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field

#: the generated kernels' entry functions (``kernels/csrc/*.cuh``), by the
#: template they belong to; ``rk::combine`` (the reducing variants' second
#: pass) and ``outer_fold`` (right_mm's second pass) belong to the launch
#: before them
KERNEL_TEMPLATES = {
    "row": ("row_kernel", "row_tile_kernel", "row_staged_kernel",
            "row_stream_kernel"),
    "outer": ("outer_kernel",),
    "cell": ("cell_no_agg", "cell_full_agg", "cell_row_agg", "cell_col_agg"),
    "magg": ("magg_scan",),
}
SECOND_PASSES = ("combine", "outer_fold")
_MAIN_RE = re.compile(r"\b(" + "|".join(
    f for fns in KERNEL_TEMPLATES.values() for f in fns) + r")\b")
_SECOND_RE = re.compile(r"\b(rk::combine|outer_fold)\b")
_TEMPLATE_OF = {f: t for t, fns in KERNEL_TEMPLATES.items() for f in fns}


@dataclass
class Op:
    name: str
    start: float
    end: float
    kernel: bool            # a kernel launch (not a copy or a memset)
    launch: float = 0.0     # when the host launched it (its runtime call)
    template: str = ""      # the generated kernel's template, or ""
    first_pass: bool = False


@dataclass
class Trace:
    window: tuple[float, float]
    ops: list[Op]                      # device operations in the window
    fits: list[tuple[float, float]]    # host fit spans in the window
    busy_s: float = 0.0
    gaps: list[tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _activity(e) -> str:
    act = getattr(e, "activity_type", None)
    return act() if callable(act) else ""


def classify(ops: list[Op]) -> None:
    """Mark each generated kernel with its template; a second pass takes
    the template of the generated kernel launched just before it."""
    last = ""
    for op in sorted(ops, key=lambda o: o.launch):
        if not op.kernel:
            continue
        m = _MAIN_RE.search(op.name)
        if m:
            op.template, op.first_pass = _TEMPLATE_OF[m.group(1)], True
            last = op.template
        elif _SECOND_RE.search(op.name) and last:
            op.template = last
        else:
            last = ""


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def to_trace_clock():
    """A function from host ``time.perf_counter()`` seconds to seconds on
    the profiler's clock, read now."""
    offset = time.time_ns() * 1e-9 - time.perf_counter()
    return lambda t: t + offset


def reduce_events(events, window: tuple[float, float],
                  fits: list[tuple[float, float]]) -> Trace:
    """A :class:`Trace` from the profiler's events (``kineto_results.
    events()``) and the benchmark's host spans on the trace's clock (the
    window, each fit): device operations inside the window, clipped to it,
    each with the host time of the runtime call that launched it."""
    device, launched = [], {}
    for e in events:
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        act = _activity(e)
        on_device = str(e.device_type()).endswith("CUDA")
        if not on_device:
            if act in ("cuda_runtime", "cuda_driver") or (
                    not act and name.startswith(("cuda", "cu"))):
                launched[e.correlation_id()] = start
        elif act != "gpu_user_annotation":
            kernel = act == "kernel" if act else not name.startswith(
                ("Memcpy", "Memset"))
            device.append((Op(name, start, end, kernel, start),
                           e.correlation_id()))
    for op, corr in device:
        op.launch = launched.get(corr, op.start)
    device = [op for op, _c in device]
    w0, w1 = window
    ops = sorted((o for o in device if o.end > w0 and o.start < w1),
                 key=lambda o: o.start)
    for o in ops:
        o.start, o.end = max(o.start, w0), min(o.end, w1)
    classify(ops)
    fits = sorted(f for f in fits if f[0] >= w0 and f[1] <= w1)
    busy = union([(o.start, o.end) for o in ops])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return Trace((w0, w1), ops, fits, sum(e - s for s, e in busy), gaps)


def ops_by_fit(trace: Trace) -> list[list[Op]]:
    """The device operations each fit span launched (by the host time of
    their launch; a fit ends in a synchronise)."""
    ops = sorted(trace.ops, key=lambda o: o.launch)
    starts = [o.launch for o in ops]
    return [ops[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]
            for s, e in trace.fits]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (by the profiler's
    names), and the longest idle gaps, each named by the benchmark's span
    open on the host at its middle (``fit``, or ``none`` between fits)."""
    by_name: dict[str, float] = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    def host(mid: float) -> str:
        return "fit" if any(s <= mid <= e for s, e in trace.fits) else "none"

    gaps = sorted(trace.gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": [[host(0.5 * (s + e)), e - s] for s, e in gaps]}


def outside_fits(trace: Trace) -> int:
    """Kernels of the window launched outside every fit span: 0 where the
    host spans and the trace's clock agree (every launch is a fit's)."""
    starts = sorted(s for s, _e in trace.fits)
    n = 0
    for o in trace.ops:
        i = bisect.bisect_right(starts, o.launch) - 1
        if o.kernel and (i < 0 or o.launch > trace.fits[i][1]):
            n += 1
    return n


def profiled(fn):
    """Run ``fn`` under ``torch.profiler``, the device's activity alone;
    returns (its result, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()
