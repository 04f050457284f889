"""The port's own host spans (:mod:`repro_torch.spans`) in a traced run:
recorded over the profiled window, moved onto the trace's clock, and read
beside the device's operations.

The harness gives its readers no hook before the window opens, so each
reader of a span metric calls :func:`install` when it is loaded, which
wraps :func:`portbench.tracing.profiled` once: the profiled window, and
no other part of a run, runs inside ``spans.recording()``.  Against a
program without ``repro_torch.spans`` nothing is recorded and the readers
read None.

From the spans of the window's fits (times in seconds on the trace's
clock):

- ``sync`` spans: the program's reads from the device, and the calls that
  make the host wait for the card;
- the self time of the ``fused.call:*`` and ``fused.backward:*`` spans
  (duration less the part their child spans cover): the host's time in
  the fused calls' dispatch, and in whatever else ran there unspanned
  (the runtime calls are logged by name, below);
- read idle: in each idle gap of the device, the time from the end of the
  first ``sync`` span that ends in it to the gap's end;
- a gap's label: the benchmark's span at its middle (``fit``, or ``none``
  between fits), then the path of program spans down to the deepest one
  open there (``fit>als_cg.run>als_cg.init``).

The first reader to ask logs, to standard error, the idle time a fit
by label (the five largest), the ten longest gaps by label (with the CUDA
runtime call running at the gap's middle, if any), the ``fused.plan`` and
``kernels.build`` spans in the window (0 once set-up has planned and built
everything), the generated kernels launched outside every ``fused.*`` span
(0 where the host spans and the trace's clock agree), and the fused
calls' self time: its median, 99th percentile and largest a call, and
how much of it the runtime calls took, by name (a launch, or a call that
may wait: an allocation, a free, a copy, a synchronise).
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass
from typing import Optional

from portbench import tracing


@dataclass
class HostSpan:
    id: int
    parent: Optional[int]
    name: str
    start: float
    end: float


@dataclass
class RuntimeCall:
    name: str
    start: float
    end: float


#: the runtime calls that launch a kernel; every other call of a fused
#: region's self time may wait (an allocation, a free, a copy)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")

_LAST: dict = {}


def install() -> None:
    """Wrap :func:`tracing.profiled` to record the program's spans over
    the window (once per process)."""
    if getattr(tracing.profiled, "records_spans", False):
        return
    plain = tracing.profiled

    def profiled(fn):
        _LAST.clear()
        try:
            from repro_torch import spans
        except ImportError:             # a program without spans
            return plain(fn)
        clock = tracing.to_trace_clock()
        with spans.recording() as rec:
            out, events = plain(fn)
        _LAST["spans"] = [HostSpan(s.id, s.parent, s.name,
                                   clock(s.start_ns * 1e-9),
                                   clock(s.end_ns * 1e-9))
                          for s in rec.spans]
        _LAST["runtime"] = runtime_calls(events)
        return out, events

    profiled.records_spans = True
    tracing.profiled = profiled


def runtime_calls(events) -> list[RuntimeCall]:
    """The host's CUDA runtime and driver calls among the profiler's
    events, by start."""
    out = []
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            continue
        act = tracing._activity(e)
        name = e.name()
        if act in ("cuda_runtime", "cuda_driver") or (
                not act and name.startswith(("cuda", "cu"))):
            start = e.start_ns() * 1e-9
            out.append(RuntimeCall(name, start, start + e.duration_ns() * 1e-9))
    return sorted(out, key=lambda c: c.start)


def recorded() -> Optional[list[HostSpan]]:
    """The spans of the last profiled window, or None."""
    return _LAST.get("spans")


def _inside(t: float, intervals: list[tuple[float, float]],
            starts: list[float]) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``intervals``."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= intervals[i][1]


def _off(t: float, intervals: list[tuple[float, float]],
         starts: list[float]) -> float:
    """How far ``t`` lies from the nearest of the sorted, disjoint
    ``intervals`` (0 inside one)."""
    i = bisect.bisect_right(starts, t) - 1
    gaps = [t - intervals[i][1]] if i >= 0 else []
    if i + 1 < len(intervals):
        gaps.append(intervals[i + 1][0] - t)
    return max(0.0, min(gaps, default=0.0))


def _covered(lo: float, hi: float, spans: list[HostSpan]) -> float:
    """Length of [lo, hi] that the union of ``spans`` covers."""
    cut = [(max(s.start, lo), min(s.end, hi)) for s in spans]
    return sum(e - s for s, e in tracing.union([c for c in cut
                                                if c[1] > c[0]]))


def gap_labels(spans: list[HostSpan], fits: list[tuple[float, float]],
               mids: list[float]) -> list[str]:
    """The label of each time in ``mids``: ``fit`` or ``none``, then the
    path of spans down to the deepest span open there (of two as deep,
    the later opened)."""
    by_id = {s.id: s for s in spans}
    depth: dict[int, int] = {}

    def depth_of(s: HostSpan) -> int:
        chain = []
        while s is not None and s.id not in depth:
            chain.append(s)
            s = by_id.get(s.parent)
        d = depth[s.id] if s is not None else -1
        for c in reversed(chain):
            d += 1
            depth[c.id] = d
        return depth[chain[0].id] if chain else d

    fit_starts = [a for a, _b in fits]
    order = sorted(spans, key=lambda s: s.start)
    out: dict[float, str] = {}
    open_, i = [], 0
    for mid in sorted(set(mids)):
        while i < len(order) and order[i].start <= mid:
            open_.append(order[i])
            i += 1
        open_ = [s for s in open_ if s.end >= mid]
        label = "fit" if _inside(mid, fits, fit_starts) else "none"
        if open_:
            deepest = max(open_, key=lambda s: (depth_of(s), s.start))
            path = []
            s = deepest
            while s is not None:
                path.append(s.name)
                s = by_id.get(s.parent)
            label = ">".join([label] + path[::-1])
        out[mid] = label
    return [out[m] for m in mids]


@dataclass
class Reading:
    sync_in_fits: int
    dispatch_s: float
    read_idle_s: float


def read(ctx) -> Optional[Reading]:
    """The window's span readings (None without a trace or spans), logged
    once per window."""
    spans = recorded()
    tr = ctx.trace
    if tr is None or spans is None:
        return None
    key = id(tr)
    if _LAST.get("read", (None,))[0] == key:
        return _LAST["read"][1]
    fits = sorted(tr.fits)
    fit_starts = [a for a, _b in fits]
    mine = [s for s in spans if _inside(s.start, fits, fit_starts)]
    children: dict[int, list[HostSpan]] = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    fused = [s for s in mine
             if s.name.startswith(("fused.call:", "fused.backward:"))]
    own = [(s, (s.end - s.start)
            - _covered(s.start, s.end, children.get(s.id, [])))
           for s in fused]
    dispatch_s = sum(t for _s, t in own)
    # read idle: per gap, from the first sync end inside it to its end
    gap_starts = [a for a, _b in tr.gaps]
    first_end: dict[int, float] = {}
    for s in spans:
        if s.name != "sync":
            continue
        g = bisect.bisect_right(gap_starts, s.end) - 1
        if g >= 0 and s.end < tr.gaps[g][1]:
            first_end[g] = min(first_end.get(g, s.end), s.end)
    read_idle_s = sum(tr.gaps[g][1] - t for g, t in first_end.items())
    reading = Reading(sum(s.name == "sync" for s in mine), dispatch_s,
                      read_idle_s)
    _LAST["read"] = (key, reading)
    calls = _LAST.get("runtime", [])
    _log(tr, spans, fits, calls)
    _log_dispatch(own, children, calls, ctx.steps)
    return reading


def _open_call(calls: list[RuntimeCall], starts: list[float],
               t: float) -> str:
    """The runtime call running at ``t``, or ""."""
    i = bisect.bisect_right(starts, t) - 1
    return calls[i].name if i >= 0 and t <= calls[i].end else ""


def _log(tr, spans: list[HostSpan], fits,
         calls: list[RuntimeCall]) -> None:
    w0, w1 = tr.window
    mids = [0.5 * (a + b) for a, b in tr.gaps]
    labels = gap_labels(spans, fits, mids)
    by_label: dict[str, float] = {}
    for (a, b), lab in zip(tr.gaps, labels):
        by_label[lab] = by_label.get(lab, 0.0) + (b - a)
    nfits = max(len(fits), 1)
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:5]
    log("idle ms a fit by label: " + "; ".join(
        f"{lab} {1e3 * s / nfits:.4f}" for lab, s in top))
    longest = sorted(zip(tr.gaps, labels), key=lambda g: g[0][0] - g[0][1])
    call_starts = [c.start for c in calls]

    def during(a, b):
        name = _open_call(calls, call_starts, 0.5 * (a + b))
        return f" (in {name})" if name else ""

    log("ten longest idle gaps: " + "; ".join(
        f"{lab} {1e3 * (b - a):.4f} ms{during(a, b)}"
        for (a, b), lab in longest[:10]))
    inside = [s for s in spans if s.end > w0 and s.start < w1]
    plans = sum(s.name.startswith("fused.plan:") for s in inside)
    builds = sum(s.name == "kernels.build" for s in inside)
    dispatch = tracing.union([(s.start, s.end) for s in spans if
                              s.name.startswith(("fused.call:",
                                                 "fused.backward:"))])
    starts = [a for a, _b in dispatch]
    generated = [o for o in tr.ops if o.kernel and o.template]
    outside = [o for o in generated
               if not _inside(o.launch, dispatch, starts)]
    # a launch the trace holds no runtime call for is dated by its start
    lost = [o for o in outside if o.launch == o.start]
    far = max((_off(o.launch, dispatch, starts) for o in outside
               if o.launch != o.start), default=0.0)
    why = (f" ({len(lost)} with no runtime call in the trace, the others "
           f"at most {1e6 * far:.1f} us outside)" if outside else "")
    log(f"in the window: {plans} fused.plan and {builds} kernels.build "
        f"spans; {len(outside)} of {len(generated)} generated-kernel "
        f"launches outside every fused.call / fused.backward span{why}")


def _log_dispatch(own: list[tuple[HostSpan, float]],
                  children: dict[int, list[HostSpan]],
                  calls: list[RuntimeCall], steps: int) -> None:
    """The fused calls' self time, each call's and by runtime call: what
    of it launched kernels, and what may have waited."""
    if not own:
        return
    times = sorted(t for _s, t in own)
    q = lambda f: 1e6 * times[min(len(times) - 1, int(f * len(times)))]
    starts = [c.start for c in calls]
    by_name: dict[str, list] = {}
    for s, _t in own:
        kids = children.get(s.id, [])
        lo = bisect.bisect_left(starts, s.start)
        for c in calls[lo:bisect.bisect_right(starts, s.end)]:
            if any(k.start <= c.start <= k.end for k in kids):
                continue
            acc = by_name.setdefault(c.name, [0, 0.0])
            acc[0] += 1
            acc[1] += min(c.end, s.end) - c.start
    per = 1e3 / max(steps, 1)
    waits = sum(t for n, (_c, t) in by_name.items() if n not in LAUNCH_CALLS)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"fused self time: {len(times)} calls, median {q(0.5):.1f} us, "
        f"p99 {q(0.99):.1f} us, max {1e6 * times[-1]:.1f} us; "
        f"{per * sum(times):.4f} ms a step, of it in runtime calls "
        + ", ".join(f"{n} {c}x {per * t:.4f}" for n, (c, t) in top)
        + f"; in calls other than launches {per * waits:.4f} ms a step")


def log(msg: str) -> None:
    print(f"[portbench] spans: {msg}", file=sys.stderr, flush=True)
