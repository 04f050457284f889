"""The program's host spans in a traced run, on the CPU: the three span
readers and the idle gaps' labels on the synthetic trace of
``test_portbench_harness`` with synthetic spans, the profiled window
recording the spans of a real fit, and a program without spans read as
nothing."""

import sys
from types import SimpleNamespace

import pytest

from portbench import hostspans, registry, tracing
from portbench.hostspans import HostSpan
from test_portbench_harness import Ev, reduced, synthetic_trace

US = 1e-6
SPAN_METRICS = ("host_reads_per_step", "dispatch_ms_per_step",
                "read_idle_share")


def synthetic_spans(call_from=0.8):
    """Spans over the synthetic trace (gaps [0, 5], [17, 20], [32, 49],
    [70, 100] µs; fits [0, 40], [50, 100]; Row launched at 1 and 51 µs,
    their combines at 2 and 52)."""
    s = lambda i, parent, name, a, b: HostSpan(i, parent, name, a * US,
                                               b * US)
    return [
        s(1, None, "l2svm.run", 0.5, 39.5),
        s(2, 1, "fused.call:_hinge", call_from, 3.0),
        s(3, 2, "py.gc", 1.2, 1.7),
        s(4, 1, "sync", 30.5, 33.0),          # ends in the gap [32, 49]
        s(5, 1, "sync", 34.0, 35.0),          # the same gap, later
        s(6, None, "l2svm.run", 50.5, 99.5),
        s(7, 6, "fused.backward:_objective_full", 50.8, 52.5),
        s(8, 6, "sync", 80.0, 90.0),          # ends in the gap [70, 100]
    ]


def ctx_for(steps=4):
    tr = reduced()
    return SimpleNamespace(trace=tr, steps=steps,
                           fits=[(40 * US, 2), (50 * US, 2)])


def synthetic_calls():
    """The runtime calls of the synthetic trace, with a free inside the
    backward's own time and a synchronise inside the last ``sync`` span."""
    return hostspans.runtime_calls(synthetic_trace() + [
        Ev("cudaFree", 50.82, 0.13, "CPU", "cuda_runtime"),
        Ev("cudaStreamSynchronize", 80.5, 9, "CPU", "cuda_runtime")])


@pytest.fixture
def spans_of(monkeypatch):
    def put(spans, calls=()):
        monkeypatch.setitem(hostspans._LAST, "spans", spans)
        monkeypatch.setitem(hostspans._LAST, "runtime", list(calls))
        hostspans._LAST.pop("read", None)
    yield put
    hostspans._LAST.clear()


def test_runtime_calls_are_the_hosts_by_start():
    calls = synthetic_calls()
    assert [c.name for c in calls] == ["cudaLaunchKernel"] * 3 + [
        "cudaFree"] + ["cudaLaunchKernel"] * 3 + ["cudaStreamSynchronize"]
    assert calls[3].start == pytest.approx(50.82 * US)
    assert calls[3].end == pytest.approx(50.95 * US)


def readers():
    return {e["name"]: m.read for e, m in
            registry.readers(registry.benchmark(), "dense-10m.l2svm")}


def test_the_span_readers_on_the_synthetic_trace(spans_of, capsys):
    spans_of(synthetic_spans(), synthetic_calls())
    read = readers()
    ctx = ctx_for()
    # three sync spans open inside the fits, over 4 steps
    assert read["host_reads_per_step"](ctx) == pytest.approx(0.75)
    # (3.0 - 0.8 - 0.5) + (52.5 - 50.8) µs of self time, over 4 steps
    assert read["dispatch_ms_per_step"](ctx) == pytest.approx(
        (1.7 + 1.7) * 1e-3 / 4)
    # (49 - 33) + (100 - 90) µs of the 100 µs window
    assert read["read_idle_share"](ctx) == pytest.approx(26.0)
    err = capsys.readouterr().err
    assert err.count("[portbench] spans:") == 4      # logged once
    assert "0 fused.plan and 0 kernels.build spans; 0 of 4 " \
        "generated-kernel launches outside" in err
    # the gap [32, 49] between the fits: 17 µs, 8.5 µs a fit
    assert "by label: fit>l2svm.run>sync 0.0150; none 0.0085;" in err
    assert "gaps: fit>l2svm.run>sync 0.0300 ms (in cudaStreamSynchronize)" \
        "; none 0.0170 ms;" in err
    # two calls of 1.7 µs own time: launches at 1, 2, 3 (none of it), 51
    # and 52 µs (half of it), and the free in the backward
    assert "fused self time: 2 calls, median 1.7 us, p99 1.7 us, " \
        "max 1.7 us;" in err
    assert "in runtime calls cudaLaunchKernel 5x 0.0009, cudaFree 1x " \
        "0.0000; in calls other than launches 0.0000 ms a step" in err


def test_a_launch_outside_the_dispatch_spans_and_a_plan_are_logged(
        spans_of, capsys):
    spans = synthetic_spans(call_from=1.5)            # Row at 1 µs outside
    spans.append(HostSpan(9, 6, "fused.plan:_hinge", 60 * US, 61 * US))
    spans_of(spans)
    hostspans.read(ctx_for())
    assert "1 fused.plan and 0 kernels.build spans; 1 of 4 " \
        "generated-kernel launches outside every fused.call / " \
        "fused.backward span (0 with no runtime call in the trace, the " \
        "others at most 0.5 us outside)" in capsys.readouterr().err


def test_a_launch_with_no_runtime_call_is_told_apart(spans_of, capsys):
    """A kernel whose runtime call the trace lost is dated by its start
    on the device, after its fused call closed."""
    events = [e for e in synthetic_trace()
              if (e.name(), e.correlation_id()) != ("cudaLaunchKernel", 1)]
    tr = tracing.reduce_events(events, (0.0, 100e-6),
                               [(0.0, 40e-6), (50e-6, 100e-6)])
    spans_of(synthetic_spans())
    ctx = ctx_for()
    ctx.trace = tr
    hostspans.read(ctx)
    # (the combine, launched before the Row's start, loses its template)
    assert "1 of 3 generated-kernel launches outside every fused.call / " \
        "fused.backward span (1 with no runtime call in the trace, the " \
        "others at most 0.0 us outside)" in capsys.readouterr().err


def test_gap_labels_name_the_spans_open_at_the_middle():
    tr = reduced()
    mids = [0.2, 2.5, 18.5, 40.5, 51.5, 85.0]
    got = hostspans.gap_labels(synthetic_spans(), tr.fits,
                               [m * US for m in mids])
    assert got == ["fit",                             # no program span
                   "fit>l2svm.run>fused.call:_hinge",
                   "fit>l2svm.run",
                   "none",                            # between the fits
                   "fit>l2svm.run>fused.backward:_objective_full",
                   "fit>l2svm.run>sync"]
    # the old labels stay prefixes, and a trace without spans keeps them
    assert hostspans.gap_labels([], tr.fits, [m * US for m in mids]) == [
        "fit", "fit", "fit", "none", "fit", "fit"]
    assert [g[0] for g in tracing.breakdown(tr)["idle_gaps"]] == [
        "fit", "none", "fit", "fit"]


def test_no_trace_or_no_spans_reads_nothing(spans_of):
    read = readers()
    ctx = ctx_for()
    hostspans._LAST.clear()
    for name in SPAN_METRICS:
        assert read[name](ctx) is None                # no spans recorded
    spans_of(synthetic_spans())
    ctx.trace = None
    for name in SPAN_METRICS:
        assert read[name](ctx) is None


def test_the_profiled_window_records_the_programs_spans(monkeypatch):
    """The wrapped ``tracing.profiled`` runs a small L2SVM fit inside
    ``spans.recording()`` (a stand-in for the profiler here) and keeps its
    spans on the trace's clock."""
    import time
    import torch
    from repro_torch.algos import data, l2svm
    monkeypatch.setattr(tracing, "profiled", lambda fn: (fn(), []))
    hostspans.install()
    assert tracing.profiled.records_spans
    X, _Y, y = data.classification(300, 6, seed=3, device="cpu")
    fit = lambda: l2svm.run(X, y, max_iter=2, eps=0.0, kernels="never",
                            device="cpu")
    fit()
    t0 = time.time()
    (w, objs), events = tracing.profiled(fit)
    t1 = time.time()
    assert isinstance(w, torch.Tensor) and len(objs) == 2 and events == []
    spans = hostspans.recorded()
    names = [s.name for s in spans]
    assert names.count("sync") == 16 and names.count("l2svm.run") == 1
    assert all(t0 - 1e-3 <= s.start <= s.end <= t1 + 1e-3 for s in spans)
    hostspans._LAST.clear()


def test_a_program_without_spans_records_nothing(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.setattr(tracing, "profiled", lambda fn: (fn(), []))
    hostspans.install()
    assert tracing.profiled(lambda: 7) == (7, [])
    assert hostspans.recorded() is None
    assert all(readers()[n](ctx_for()) is None for n in SPAN_METRICS)
