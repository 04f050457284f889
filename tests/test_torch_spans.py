"""The port's host span recorder (``repro_torch.spans``): the no-op object
with nothing installed, nesting, parents and threads, the collector hook's
lifetime, and the spans of one small fit of L2SVM, MLogReg, K-Means and
ALS-CG on the CPU (``kernels="never"``): the predicted reads a step, one
``fused.call`` span a fused call, every span under the fit's ``run``.

The test marked ``gpu`` runs each fit on the card under
``torch.cuda.set_sync_debug_mode(1)`` and finds every synchronising call
inside a ``sync`` span (``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_spans.py``).  Imports no JAX.
"""

import gc
import inspect
import threading
import warnings

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.algos import als_cg, data, kmeans, l2svm, mlogreg
from repro_torch.core import api, fused, ir
from repro_torch.kernels import build


def test_nothing_installed_records_nothing():
    assert spans.active() is None
    a, b = spans.span("x"), spans.span("y")
    assert a is b is spans.NOOP
    with a as inner:
        assert inner is a
    with spans.recording() as rec:
        assert spans.active() is rec
        assert spans.span("x") is not a
    assert spans.active() is None
    with spans.span("after"):
        pass
    assert [s.name for s in rec.spans] == []


def test_one_recorder_at_a_time():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans.active() is None


def test_nesting_parents_and_threads():
    seen = {}

    def worker():
        with spans.span("worker"):
            with spans.span("worker.child"):
                seen["thread"] = threading.get_ident()

    with spans.recording() as rec:
        with spans.span("a.run"):
            with spans.span("b"):
                with spans.span("c"):
                    pass
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
            assert not t.is_alive()
        with spans.span("loose"):
            pass
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"a.run", "b", "c", "worker", "worker.child", "loose"}
    assert by["a.run"].parent is None and by["loose"].parent is None
    assert by["b"].parent == by["a.run"].id
    assert by["c"].parent == by["b"].id
    # a thread with no span open takes the innermost open *.run span
    assert by["worker"].parent == by["a.run"].id
    assert by["worker.child"].parent == by["worker"].id
    assert by["worker"].thread == seen["thread"] != by["a.run"].thread
    assert by["c"].thread == by["a.run"].thread
    assert len({s.id for s in rec.spans}) == 6
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None and s.name != "worker":
            p = next(q for q in rec.spans if q.id == s.parent)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_one_name_nested_in_itself_and_the_open_names():
    with spans.recording() as rec:
        with spans.span("a.run"):
            with spans.span("a"):
                with spans.span("a"):
                    assert rec.open_names() == ["a.run", "a", "a"]
                assert rec.open_names() == ["a.run", "a"]
    assert rec.open_names() == []
    inner, outer, run = rec.spans
    assert (inner.name, outer.name, run.name) == ("a", "a", "a.run")
    assert inner.parent == outer.id and outer.parent == run.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_recording_leaves_nothing_for_the_collector():
    """A recorded span keeps no object that the cyclic collector tracks,
    so recording makes it run no more often."""
    with spans.recording() as rec:
        with spans.span("warm"):
            pass
        gc.collect()
        before = len(gc.get_objects())
        for _ in range(1000):
            with spans.span("sync"):
                pass
        after = len(gc.get_objects())
    assert after - before < 50
    assert sum(s.name == "sync" for s in rec.spans) == 1000


def test_spanned_keeps_the_signature_and_records_each_call():
    @spans.spanned("f.run")
    def f(x, k: int = 2):
        """doc"""
        with spans.span("inner"):
            return x * k

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert list(inspect.signature(f).parameters) == ["x", "k"]
    with spans.recording() as rec:
        assert f(3) == 6 and f(1, k=5) == 5
    names = [s.name for s in rec.spans]
    assert names.count("f.run") == 2 and names.count("inner") == 2


@pytest.mark.parametrize("raises", [False, True])
def test_the_gc_hook_lives_only_while_recording(raises):
    before = list(gc.callbacks)
    with pytest.raises(ValueError) if raises else _nothing():
        with spans.recording() as rec:
            assert len(gc.callbacks) == len(before) + 1
            with spans.span("outer"):
                gc.collect()
            if raises:
                raise ValueError("the block fails")
    assert gc.callbacks == before
    assert spans.active() is None
    passes = [s for s in rec.spans if s.name == "py.gc"]
    outer = next(s for s in rec.spans if s.name == "outer")
    assert passes and all(p.parent == outer.id for p in passes)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_plan_and_build_spans_on_a_miss():
    region = fused(lambda X, w: ir.relu(X @ w).sum())
    X = torch.randn(64, 4)
    w = torch.randn(4, 1, requires_grad=True)
    with spans.recording() as rec:
        with api.FusionContext(kernels="never", device="cpu"):
            for _ in range(2):
                (g,) = torch.autograd.grad(region(X, w)[0, 0], w)
        build.build_all([])
    names = [s.name for s in rec.spans]
    assert names.count("fused.call:<lambda>") == 2
    assert names.count("fused.plan:<lambda>") == 2      # forward, backward
    assert names.count("fused.backward:<lambda>") == 2
    assert names.count("kernels.build") == 1
    by_id = {s.id: s for s in rec.spans}
    plans = [s for s in rec.spans if s.name.startswith("fused.plan")]
    assert {by_id[p.parent].name for p in plans} == {
        "fused.call:<lambda>", "fused.backward:<lambda>"}


def test_a_copy_to_the_cpu_is_no_sync():
    from repro_torch.interop import to_torch
    with spans.recording() as rec:
        to_torch(np.ones((3, 2)), "cpu")
        to_torch(torch.ones(3, 2, dtype=torch.float64), "cpu")
    assert rec.spans == []


# -- the fits ----------------------------------------------------------------

ITERS = 3


def _fits(device):
    X, Y, y = data.classification(400, 8, k=3, seed=1, device=device)
    Xk, C0 = data.clusters(400, 8, k=3, seed=2, device=device)
    R = data.ratings(256, 256, rank=4, bs=128, block_density=1.0, seed=0,
                     device=device)
    kw = dict(kernels="never" if device == "cpu" else "cuda", device=device)
    return {
        # (the fit, reads a step, fused calls a step, backward calls a step)
        "l2svm": (lambda: l2svm.run(X, y, max_iter=ITERS, eps=0.0, **kw),
                  8, 3, 1),
        "mlogreg": (lambda: mlogreg.run(X, Y, max_outer=ITERS, max_inner=3,
                                        eps=0.0, **kw), 8, 5, 1),
        "kmeans": (lambda: kmeans.run(Xk, C0, max_iter=ITERS, eps=0.0, **kw),
                   2, 1, 0),
        "als_cg": (lambda: als_cg.run(R, rank=4, max_iter=ITERS, max_inner=5,
                                      eps=0.0, **kw), 25, 13, 0),
    }


FIXED = {  # spans a fit outside its steps: (reads, fused calls, backward)
    "l2svm": (0, 1, 1),               # the first gradient
    "mlogreg": (0, 0, 0),
    "kmeans": (0, 1, 0),               # the row norms of X
    "als_cg": (0, 0, 0),
}


def _count(rec, prefix):
    return sum(s.name.startswith(prefix) for s in rec.spans)


@pytest.mark.parametrize("algo", list(FIXED))
def test_a_fit_spans_its_reads_and_fused_calls(algo, monkeypatch):
    fit, reads, calls, backs = _fits("cpu")[algo]
    fit()                                   # planned and compiled
    compiled_calls = []
    plain = api.Compiled.__call__
    monkeypatch.setattr(api.Compiled, "__call__", lambda self, *a, **k: (
        compiled_calls.append(1), plain(self, *a, **k))[1])
    with spans.recording() as rec:
        fit()
    f_reads, f_calls, f_backs = FIXED[algo]
    assert _count(rec, "sync") == ITERS * reads + f_reads
    assert _count(rec, "fused.call:") == len(compiled_calls) \
        == ITERS * calls + f_calls
    assert _count(rec, "fused.backward:") == ITERS * backs + f_backs
    assert _count(rec, "fused.plan:") == _count(rec, "kernels.build") == 0
    by_id = {s.id: s for s in rec.spans}
    # a collector pass may run before the fit opens or after it closes
    mine = [s for s in rec.spans if s.parent is not None or s.name != "py.gc"]
    (root,) = [s for s in mine if s.parent is None]
    assert root.name == f"{algo}.run"
    assert _count(rec, f"{algo}.init") == 1
    for s in mine:
        top = s
        while top.parent is not None:
            top = by_id[top.parent]
        assert top == root
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


@pytest.mark.gpu
def test_every_synchronising_call_on_the_card_is_in_a_sync_span():
    """``set_sync_debug_mode(1)`` warns at each call that makes the host
    wait for the card; a hook finds whether a ``sync`` span is open on the
    calling thread then."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fits = _fits("cuda")
    for fit, *_ in fits.values():
        fit()                               # planned, built, warm
    torch.cuda.synchronize()
    for algo, (fit, *_rest) in fits.items():
        found = []

        def hook(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing" in str(message):
                found.append(("sync" in spans.active().open_names(),
                              str(message)[:120], filename, lineno))

        with spans.recording() as rec, warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode(1)
            try:
                fit()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        outside = sorted({f[2:] for f in found if not f[0]})
        assert found, f"{algo}: no synchronising call seen"
        assert not outside, (algo, outside)
