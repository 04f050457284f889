"""Chaos suite of the port: seeded fault injection against its
self-healing FusionServer.

Counterparts of ``tests/test_faults.py`` under the same schedules and
seeds.  The invariant under every schedule: **no request is lost** —
every submitted future resolves with either a result (1e-5 parity
against the direct call of the reference's region on the same numpy
inputs, and of the port's) or a typed :class:`FusionServeError`; the
worker pool recovers to full size.  The port's sites map to the
reference's: ``plan.build`` ↔ ``plan.jit_build``, ``kernels.launch`` ↔
``kernels.pallas_call``, ``serve.batch_dispatch``, ``serve.worker`` and
``dist.segment`` alike.

Fault-test regions use distinct literal constants on purpose: the
whole-plan cache is process-global and keyed structurally, so a region
structurally identical to another test's would hit the cache and skip
the build fault site.  The port serves on the CPU (``kernels="never"``,
the plain versions of the request-axis kernels); ``chip_smoke.py``'s
``[chaos]`` phase runs a schedule on the card.
"""

import os
import time

import numpy as np
import pytest
import torch

from repro import faults as ref_faults
from repro.core import fused as ref_fused
from repro.core import ir as ref_ir
from repro_torch import faults
from repro_torch.core import FusionContext, fused, ir
from repro_torch.serve import (DeadlineExceededError, FusionServeError,
                               FusionServer, NonFiniteOutputError,
                               PlanQuarantinedError, QueueFullError,
                               RequestFailedError, ServerClosedError)

rng = np.random.default_rng(23)
CTX = FusionContext(device="cpu", kernels="never")

#: the port's site -> the reference's
SITE_MAP = {"plan.build": "plan.jit_build",
            "kernels.launch": "kernels.pallas_call",
            "serve.batch_dispatch": "serve.batch_dispatch",
            "serve.worker": "serve.worker",
            "dist.segment": "dist.segment"}


def _hinge(c=1.0):
    """(port region, reference region) of the l2svm scoring term; the
    literal c makes the plan structurally unique per test."""
    return (fused(lambda X, w, y: ir.relu(c - y * (X @ w))),
            ref_fused(lambda X, w, y: ref_ir.relu(c - y * (X @ w))))


def _probs():
    def probs(ir_):
        def probs(X, W):
            E = ir_.exp(X @ W)
            return E / E.rowsums()
        return probs
    return fused(probs(ir)), ref_fused(probs(ref_ir))


def _hinge_args(m, k=16):
    X = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, 1)).astype(np.float32)
    y = np.sign(rng.normal(size=(m, 1))).astype(np.float32)
    return X, w, y


def _parity(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def _direct(pair, *args):
    """The reference's direct call, after checking the port's equals it."""
    port, ref = pair
    want = np.asarray(ref(*args))
    with CTX:
        _parity(port(*args), want)
    return want


def _server(**kw):
    return FusionServer(context=CTX, **kw)


# --------------------------------------------------------------------------
# the faults subsystem itself
# --------------------------------------------------------------------------

def test_registry_covers_the_stack():
    sites = {s.name: s for s in faults.ensure_registered()}
    ref_sites = {s.name for s in ref_faults.ensure_registered()}
    assert set(sites) == set(SITE_MAP)
    assert set(SITE_MAP.values()) == ref_sites
    for name, site in sites.items():
        assert site.handler.strip(), f"{name} has no handler"
        assert site.kinds


def test_schedule_is_deterministic_and_matches_the_reference():
    rules = [("s", "error", 0.3, (), 5), ("s", "latency", 0.0, (2, 4), None)]

    def run(mod, seed):
        sched = mod.FaultSchedule([mod.FaultRule(s, kind=k, p=p, at=at,
                                                 count=c)
                                   for s, k, p, at, c in rules], seed=seed)
        fired = [sched.poke("s") is not None for _ in range(50)]
        return fired, sched.events()

    a, b = run(faults, 42), run(faults, 42)
    assert a == b
    assert any(a[0])
    assert a == run(ref_faults, 42)            # the reference's sequence
    assert run(faults, 43)[0] != a[0]


def test_fault_point_kinds_and_uninstall():
    assert faults.fault_point("anything") is None
    sched = faults.FaultSchedule([
        faults.FaultRule("a", kind="error", at=(0,), message="boom"),
        faults.FaultRule("b", kind="crash", at=(0,)),
        faults.FaultRule("c", kind="latency", at=(0,), delay_s=0.05),
        faults.FaultRule("d", kind="nonfinite", at=(0,)),
    ])
    with faults.inject(sched):
        with pytest.raises(faults.FaultInjected, match="boom"):
            faults.fault_point("a")
        with pytest.raises(faults.WorkerCrash):
            faults.fault_point("b")
        t0 = time.perf_counter()
        assert faults.fault_point("c") is None
        assert time.perf_counter() - t0 >= 0.04
        rule = faults.fault_point("d")
        assert rule is not None and rule.kind == "nonfinite"
        assert faults.fault_point("d") is None
    assert faults.active() is None
    assert sched.events() == [("a", "error", 0), ("b", "crash", 0),
                              ("c", "latency", 0), ("d", "nonfinite", 0)]


def test_poison_structure():
    p = faults.poison((np.ones((2, 2), np.float32), np.float32(3.0)))
    assert isinstance(p, tuple) and np.isnan(p[0]).all() and np.isnan(p[1])
    t = faults.poison((torch.ones(2, 3), torch.zeros(1, 1)))
    assert all(isinstance(v, torch.Tensor) and v.isnan().all() for v in t)


# --------------------------------------------------------------------------
# fault sites outside the server
# --------------------------------------------------------------------------

def test_dist_segment_fault_degrades_to_fallback():
    from repro_torch.kernels.distributed import (SegmentFallback,
                                                 plan_segment)
    sched = faults.FaultSchedule([
        faults.FaultRule("dist.segment", kind="error", at=(0,),
                         message="mesh gone")])
    with faults.inject(sched):
        fb = plan_segment([], mesh=None)
        assert isinstance(fb, SegmentFallback)
        assert "injected fault" in fb.reason           # recorded, not raised
        fb2 = plan_segment([], mesh=None)              # next hit: normal path
        assert "injected" not in fb2.reason
    assert sched.events() == [("dist.segment", "error", 0)]


def test_kernels_launch_fault_surfaces_and_recovers():
    """The counterpart of ``kernels.pallas_call``: a kernel dispatch that
    fails surfaces to the caller; nothing is cached, a retry runs."""
    pair = _hinge(1.0731)
    X, w, y = _hinge_args(24)
    planned = pair[0].trace(X=X, w=w, y=y).plan(context=CTX)
    sched = faults.FaultSchedule([
        faults.FaultRule("kernels.launch", kind="error", at=(0,))])
    with faults.inject(sched):
        compiled = planned.compile(kernels="cuda")
        with pytest.raises(faults.FaultInjected):
            compiled(X, w, y)
        _parity(compiled(X, w, y).detach(), _direct(pair, X, w, y))
    assert sched.events() == [("kernels.launch", "error", 0)]
    # kernels="never" dispatches no kernel: the site never fires
    with faults.inject(faults.FaultSchedule([
            faults.FaultRule("kernels.launch", kind="error", at=(0,))])):
        planned.compile(kernels="never")(X, w, y)


# --------------------------------------------------------------------------
# server: build ladder, bisection, degradation, nonfinite
# --------------------------------------------------------------------------

def test_build_fault_degrades_to_exact_shape_serving():
    pair = _hinge(1.0417)
    X, w, y = _hinge_args(50)
    server = _server(workers=1, max_batch=4, pad_to=32)
    try:
        sched = faults.FaultSchedule([
            faults.FaultRule("plan.build", kind="error", at=(0,))])
        with faults.inject(sched):
            got = server.submit(pair[0], X, w, y).result(timeout=300)
        _parity(got, _direct(pair, X, w, y))
        assert sched.events(), "build fault never fired"
        snap = server.metrics.snapshot()
        fb = [r for r in snap["runtime_fallbacks"]
              if r["site"] == "plan.build"]
        assert fb and fb[0]["tier"] == "exact"       # explicit, counted
        assert snap["requests"]["completed"] == 1
        assert snap["requests"]["failed"] == 0
    finally:
        server.close()


def test_batch_dispatch_error_bisects_and_isolates():
    pair = _hinge(1.0523)
    cases = [_hinge_args(m) for m in (20, 25, 31, 32)]
    server = _server(workers=1, max_batch=8, pad_to=32, autostart=False)
    server._started = True
    try:
        futs = [server.submit(pair[0], *args) for args in cases]
        server._started = False
        sched = faults.FaultSchedule([
            faults.FaultRule("serve.batch_dispatch", kind="error",
                             at=(0,))])
        with faults.inject(sched):
            server.start()
            results = [f.result(timeout=300) for f in futs]
        for args, got in zip(cases, results):
            _parity(got, _direct(pair, *args))
        snap = server.metrics.snapshot()
        assert snap["requests"]["completed"] == 4
        assert snap["requests"]["failed"] == 0
        assert snap["resilience"]["bisections"] >= 1
        assert snap["batches"]["failed_dispatches"] >= 1
    finally:
        server.close()


def test_nonfinite_injection_degrades_with_parity():
    pair = _hinge(1.0611)
    cases = [_hinge_args(m) for m in (20, 28)]
    server = _server(workers=1, max_batch=4, pad_to=32, check_finite=True,
                     autostart=False)
    server._started = True
    try:
        futs = [server.submit(pair[0], *args) for args in cases]
        server._started = False
        sched = faults.FaultSchedule([
            faults.FaultRule("serve.batch_dispatch", kind="nonfinite",
                             at=(0,))])
        with faults.inject(sched):
            server.start()
            results = [f.result(timeout=300) for f in futs]
        for args, got in zip(cases, results):
            _parity(got, _direct(pair, *args))
        snap = server.metrics.snapshot()
        assert snap["resilience"]["nonfinite_detected"] >= 2
        assert snap["resilience"]["degraded"].get("exact", 0) >= 2
        assert snap["requests"]["failed"] == 0
    finally:
        server.close()


def test_nan_operand_fails_only_its_own_future():
    pair = _hinge(1.0337)
    good = [_hinge_args(m) for m in (20, 25, 31)]
    Xbad, wbad, ybad = _hinge_args(24)
    Xbad[3, 2] = np.nan
    server = _server(workers=1, max_batch=8, pad_to=32, check_finite=True,
                     retry_budget=2, autostart=False)
    server._started = True
    try:
        futs = [server.submit(pair[0], *args) for args in good]
        bad = server.submit(pair[0], Xbad, wbad, ybad)
        server._started = False
        server.start()
        for args, f in zip(good, futs):
            _parity(f.result(timeout=300), _direct(pair, *args))
        with pytest.raises((NonFiniteOutputError, RequestFailedError)):
            bad.result(timeout=300)
        snap = server.metrics.snapshot()
        assert snap["requests"]["completed"] == 3
        assert snap["requests"]["failed"] == 1
    finally:
        server.close()


# --------------------------------------------------------------------------
# server: worker crash, deadlines, backpressure, close
# --------------------------------------------------------------------------

def test_worker_crash_requeues_and_respawns():
    pair = _hinge(1.0129)
    cases = [_hinge_args(m) for m in (20, 25, 31, 32)]
    server = _server(workers=2, max_batch=4, pad_to=32, autostart=False)
    server._started = True
    try:
        futs = [server.submit(pair[0], *args) for args in cases]
        server._started = False
        sched = faults.FaultSchedule([
            faults.FaultRule("serve.worker", kind="crash", at=(0,))])
        with faults.inject(sched):
            server.start()
            for args, f in zip(cases, futs):
                _parity(f.result(timeout=300), _direct(pair, *args))
        snap = server.metrics.snapshot()
        assert snap["resilience"]["workers"]["crashes"] == 1
        assert snap["resilience"]["workers"]["respawns"] == 1
        assert snap["resilience"]["workers"]["requeued_requests"] >= 1
        alive = [t for t in server._threads if t.is_alive()]
        assert len(alive) == server.workers
    finally:
        server.close()


def test_deadline_exceeded_is_typed():
    pair = _hinge(1.0251)
    X, w, y = _hinge_args(20)
    server = _server(workers=1, max_batch=2, pad_to=32, autostart=False)
    server._started = True
    try:
        fut = server.submit(pair[0], X, w, y, deadline_s=0.001)
        time.sleep(0.05)
        server._started = False
        server.start()
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=300)
        assert server.metrics.snapshot()["requests"][
            "deadline_exceeded"] == 1
    finally:
        server.close()


def test_bounded_queue_backpressure():
    pair = _hinge(1.0183)
    args = _hinge_args(20)
    server = _server(workers=1, max_batch=2, pad_to=32, max_queue=2,
                     autostart=False)
    server._started = True
    try:
        futs = [server.submit(pair[0], *args) for _ in range(2)]
        with pytest.raises(QueueFullError):
            server.submit(pair[0], *args)
        snap = server.metrics.snapshot()
        assert snap["resilience"]["rejected"]["backpressure"] == 1
        server._started = False
        server.start()
        for f in futs:
            _parity(f.result(timeout=300), _direct(pair, *args))
    finally:
        server.close()


def test_close_resolves_queued_futures():
    pair = _hinge(1.0457)
    args = _hinge_args(20)
    server = _server(workers=1, max_batch=2, pad_to=32, autostart=False)
    server._started = True
    futs = [server.submit(pair[0], *args) for _ in range(3)]
    server.close()
    for f in futs:
        assert f.done()
        with pytest.raises(ServerClosedError):
            f.result(timeout=0)
    assert server.metrics.snapshot()["requests"]["cancelled"] == 3


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

def test_breaker_quarantines_and_recovers():
    pair = _hinge(1.0871)
    X, w, y = _hinge_args(20)
    server = _server(workers=1, max_batch=2, pad_to=32, retry_budget=0,
                     breaker_threshold=2, breaker_cooldown_s=0.3)
    try:
        sched = faults.FaultSchedule([
            faults.FaultRule("serve.batch_dispatch", kind="error",
                             at=(0, 1, 2))])
        with faults.inject(sched):
            for _ in range(2):
                with pytest.raises(RequestFailedError):
                    server.submit(pair[0], X, w, y).result(timeout=300)
            with pytest.raises(PlanQuarantinedError):
                server.submit(pair[0], X, w, y)
            time.sleep(0.35)
            with pytest.raises(RequestFailedError):
                server.submit(pair[0], X, w, y).result(timeout=300)
            with pytest.raises(PlanQuarantinedError):
                server.submit(pair[0], X, w, y)
            time.sleep(0.35)
            got = server.submit(pair[0], X, w, y).result(timeout=300)
        _parity(got, _direct(pair, X, w, y))
        snap = server.metrics.snapshot()
        assert snap["resilience"]["breaker"]["opens"] == 2
        assert snap["resilience"]["breaker"]["probes"] == 2
        assert snap["resilience"]["breaker"]["closes"] == 1
        assert snap["resilience"]["rejected"]["quarantined"] == 2
        report = server.metrics.report(server)
        assert report["server"]["breaker"]["quarantined"] == []
    finally:
        server.close()


# --------------------------------------------------------------------------
# randomized chaos sweep (the reference's schedules and seeds)
# --------------------------------------------------------------------------

N_CASES = int(os.environ.get("REPRO_CHAOS_CASES", "6"))


def _random_schedule(case_rng) -> faults.FaultSchedule:
    rules = []
    if case_rng.random() < 0.8:
        kind = case_rng.choice(["error", "nonfinite", "latency"])
        rules.append(faults.FaultRule(
            "serve.batch_dispatch", kind=str(kind),
            p=float(case_rng.uniform(0.05, 0.3)),
            count=int(case_rng.integers(1, 6)), delay_s=0.005))
    if case_rng.random() < 0.5:
        rules.append(faults.FaultRule(
            "serve.worker", kind="crash",
            p=float(case_rng.uniform(0.02, 0.12)),
            count=int(case_rng.integers(1, 3))))
    if case_rng.random() < 0.3:
        rules.append(faults.FaultRule(
            "serve.worker", kind="latency", p=0.2, count=3,
            delay_s=0.005))
    return faults.FaultSchedule(rules, seed=int(case_rng.integers(1 << 30)))


@pytest.mark.parametrize("case", range(N_CASES))
def test_chaos_no_request_lost(case):
    case_rng = np.random.default_rng(1000 + case)
    hinge, probs = _hinge(1.0 + case / 512.0), _probs()
    W = rng.normal(size=(16, 5)).astype(np.float32)
    cases = []
    for m in (20, 40, 25, 33):
        cases.append((hinge, _hinge_args(m)))
        Xp = rng.normal(size=(m, 16)).astype(np.float32)
        cases.append((probs, (Xp, W)))
    refs = [_direct(pair, *args) for pair, args in cases]
    sched = _random_schedule(case_rng)
    server = _server(workers=2, max_batch=4, pad_to=32, check_finite=True,
                     retry_budget=4)
    try:
        with faults.inject(sched):
            futs = [server.submit(pair[0], *args) for pair, args in cases]
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(("ok", f.result(timeout=300)))
                except FusionServeError as e:
                    outcomes.append(("err", e))
            for f in futs:
                assert f.done(), "request lost: future never resolved"
        for (kind, val), ref in zip(outcomes, refs):
            if kind == "ok":
                _parity(val, ref)
        alive = [t for t in server._threads if t.is_alive()]
        assert len(alive) == server.workers, "a worker stayed dead"
        snap = server.metrics.snapshot()
        resolved = (snap["requests"]["completed"] +
                    snap["requests"]["failed"] +
                    snap["requests"]["deadline_exceeded"])
        assert resolved == len(cases)
    finally:
        server.close()
    assert faults.active() is None
