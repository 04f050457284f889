"""The port's FusionServer against the reference's, request for request.

Counterparts of ``tests/test_serving.py``: each test submits the same
numpy inputs to the reference ``FusionServer`` (JAX, ``jit(vmap)``
batches) and to the port's (``device="cpu"``, ``kernels="never"``: the
batched plan function runs the plain versions of the request-axis
kernels) and compares the served results with each other and with the
direct region call, and the servers' counters with each other.  The
pad-safety analysis must return the reference's ``PadReport`` on every
region.  Parity uses rtol=1e-5 and atol=1e-5, as the reference's tests.
Servers are always closed in ``finally``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused as ref_fused
from repro.core import ir as ref_ir
from repro.serve import FusionServer as RefServer
from repro.serve import pad_safety as ref_pad_safety
from repro_torch.core import FusionContext, fused, ir
from repro_torch.serve import (FusionServeError, FusionServer, PadReport,
                               ServerClosedError, pad_safety)

rng = np.random.default_rng(11)
CTX = FusionContext(device="cpu", kernels="never")


def _hinge_pair():
    return (fused(lambda X, w, y: ir.relu(1.0 - y * (X @ w))),
            ref_fused(lambda X, w, y: ref_ir.relu(1.0 - y * (X @ w))))


def _probs_pair():
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


def _direct(region, *args):
    with CTX:
        return region(*args)


def _servers(**kw):
    return FusionServer(context=CTX, **kw), RefServer(**kw)


def _paused(**kw):
    """Both servers admitting without draining (deterministic batches)."""
    port, ref = _servers(autostart=False, **kw)
    port._started = ref._started = True
    return port, ref


def _drain(*servers):
    for s in servers:
        s._started = False
        s.start()


# --------------------------------------------------------------------------
# request path: submit → Future → parity with the reference and direct calls
# --------------------------------------------------------------------------

def test_submit_matches_direct_call():
    region, ref_region = _hinge_pair()
    X, w, y = _hinge_args(50)
    port, ref = _servers(workers=1, max_batch=4, pad_to=32)
    try:
        got = port.submit(region, X, w, y).result(timeout=300)
        want = ref.submit(ref_region, X, w, y).result(timeout=300)
        assert isinstance(got, torch.Tensor)    # on the server's device
        assert got.device == port.device == torch.device("cpu")
        assert tuple(got.shape) == want.shape == (50, 1)
        _parity(got, want)
        _parity(got, _direct(region, X, w, y))
    finally:
        port.close()
        ref.close()


def test_vector_world_round_trip():
    region, ref_region = _hinge_pair()
    X, w, y = _hinge_args(40)
    y1 = y.reshape(-1)
    port, ref = _servers(workers=1, max_batch=4, pad_to=32)
    try:
        got = port.submit(region, X, w, y1).result(timeout=300)
        want = ref.submit(ref_region, X, w, y1).result(timeout=300)
        assert tuple(got.shape) == want.shape == (40,)
        assert tuple(_direct(region, X, w, y1).shape) == (40,)
        _parity(got, want)
    finally:
        port.close()
        ref.close()


def test_batching_and_padding_mixed_sizes():
    """Four row counts of one 32-row class: ONE batched dispatch in both
    servers, each result sliced back to its rows; equal counters."""
    region, ref_region = _hinge_pair()
    ms = (20, 25, 31, 32)
    cases = [_hinge_args(m) for m in ms]
    port, ref = _paused(workers=1, max_batch=8, pad_to=32)
    try:
        futs = [(port.submit(region, *a), ref.submit(ref_region, *a))
                for a in cases]
        _drain(port, ref)
        for m, args, (f, rf) in zip(ms, cases, futs):
            got, want = f.result(timeout=300), rf.result(timeout=300)
            assert tuple(got.shape) == want.shape == (m, 1)
            _parity(got, want)
            _parity(got, _direct(region, *args))
        snaps = [s.metrics.snapshot() for s in (port, ref)]
        for snap in snaps:
            assert snap["batches"]["count"] == 1
            assert snap["batches"]["occupancy_max"] == 4
            assert snap["batches"]["padded_requests"] == 3
            assert snap["compiles"]["count"] == 1
        for key in ("count", "batched_requests", "padded_requests",
                    "occupancy_mean", "pad_fallbacks"):
            assert snaps[0]["batches"][key] == snaps[1]["batches"][key]
        assert snaps[0]["requests"] == snaps[1]["requests"]
    finally:
        port.close()
        ref.close()


def test_three_buckets_interleaved():
    (hinge, ref_hinge), (probs, ref_probs) = _hinge_pair(), _probs_pair()
    W = rng.normal(size=(16, 5)).astype(np.float32)
    cases = []
    for m in (20, 40, 20, 33, 40, 21):
        cases.append((hinge, ref_hinge, _hinge_args(m)))
        Xp = rng.normal(size=(m, 16)).astype(np.float32)
        cases.append((probs, ref_probs, (Xp, W)))
    port, ref = _servers(workers=2, max_batch=4, pad_to=32)
    try:
        futs = [(port.submit(r, *a), ref.submit(rr, *a))
                for r, rr, a in cases]
        for (r, _rr, a), (f, rf) in zip(cases, futs):
            got = f.result(timeout=300)
            _parity(got, rf.result(timeout=300))
            _parity(got, _direct(r, *a))
        for s in (port, ref):
            snap = s.metrics.snapshot()
            assert len(snap["buckets"]) >= 3
            assert snap["requests"]["completed"] == len(cases)
            assert snap["requests"]["failed"] == 0
    finally:
        port.close()
        ref.close()


# --------------------------------------------------------------------------
# pad safety
# --------------------------------------------------------------------------

def _pad_regions():
    """(name, port expr, reference expr, operand shapes, padded names):
    every region ``tests/test_serving.py`` analyses."""
    def both(make):
        return make(ir), make(ref_ir)

    return [
        ("hinge", *both(lambda ir_: lambda X, w, y:
                        ir_.relu(1.0 - y * (X @ w))),
         ((64, 16), (16, 1), (64, 1)), {"X", "y"}),
        ("sum_sq", *both(lambda ir_: lambda X: (X * X).sum()),
         ((64, 8),), {"X"}),
        ("plus_one_sum", *both(lambda ir_: lambda X: (X + 1.0).sum()),
         ((64, 8),), {"X"}),
        ("exp_colsums", *both(lambda ir_: lambda X: ir_.exp(X).colsums()),
         ((64, 8),), {"X"}),
        ("mean", *both(lambda ir_: lambda X: X.mean()), ((64, 8),), {"X"}),
        ("relu_rowsums", *both(lambda ir_: lambda X: ir_.relu(X).rowsums()),
         ((64, 8),), {"X"}),
        ("probs", *both(lambda ir_: (lambda X, W: ir_.exp(X @ W)
                                     / ir_.exp(X @ W).rowsums())),
         ((64, 16), (16, 5)), {"X"}),
        ("two_sums", *both(lambda ir_: lambda X, Y:
                           ((X * Y).sum(), (X ** 2).sum())),
         ((64, 8), (64, 8)), {"X", "Y"}),
    ]


def _op_reason(reason: str) -> str:
    return re.sub(r"^%\d+ ", "", reason)


@pytest.mark.parametrize("name,port_fn,ref_fn,shapes,padded",
                         [pytest.param(*r, id=r[0]) for r in _pad_regions()])
def test_pad_safety_matches_the_reference(name, port_fn, ref_fn, shapes,
                                          padded):
    g = fused(port_fn).trace(*[torch.empty(s, device="meta")
                               for s in shapes]).graph
    rg = ref_fused(ref_fn).trace(*[jax.ShapeDtypeStruct(s, jnp.float32)
                                   for s in shapes]).graph
    rep = pad_safety(g, frozenset(padded))
    want = ref_pad_safety(rg, frozenset(padded))
    assert isinstance(rep, PadReport)
    # node ids count per package: the reason is compared after its "%nid"
    assert (rep.safe, rep.out_axes, _op_reason(rep.reason)) == \
        (want.safe, want.out_axes, _op_reason(want.reason))


def test_pad_safety_analysis_unit():
    g = fused(lambda X, w, y: ir.relu(1.0 - y * (X @ w))).trace(
        torch.empty(64, 16, device="meta"), torch.empty(16, 1, device="meta"),
        torch.empty(64, 1, device="meta")).graph
    rep = pad_safety(g, frozenset({"X", "y"}))
    assert rep.safe and rep.out_axes == (0,)
    g = fused(lambda X: (X + 1.0).sum()).trace(
        torch.empty(64, 8, device="meta")).graph
    rep = pad_safety(g, frozenset({"X"}))
    assert not rep.safe and "sum" in rep.reason


def test_pad_unsafe_region_falls_back_to_exact_buckets():
    region = fused(lambda X: (X + 1.0).sum())
    ref_region = ref_fused(lambda X: (X + 1.0).sum())
    X1 = rng.normal(size=(20, 8)).astype(np.float32)
    X2 = rng.normal(size=(20, 8)).astype(np.float32)
    X3 = rng.normal(size=(24, 8)).astype(np.float32)
    port, ref = _paused(workers=1, max_batch=4, pad_to=32)
    try:
        futs = [(port.submit(region, X), ref.submit(ref_region, X))
                for X in (X1, X2, X3)]
        _drain(port, ref)
        for X, (f, rf) in zip((X1, X2, X3), futs):
            got = f.result(timeout=300)
            assert tuple(got.shape) == (1, 1)
            _parity(got, rf.result(timeout=300))
            _parity(got, (X.astype(np.float64) + 1.0).sum())
        snaps = [s.metrics.snapshot() for s in (port, ref)]
        for snap in snaps:
            assert snap["batches"]["pad_fallbacks"] == 2
            assert snap["batches"]["padded_requests"] == 0
            assert snap["batches"]["occupancy_max"] == 2
            assert snap["compiles"]["count"] == 2
        assert snaps[0]["batches"] == snaps[1]["batches"]
    finally:
        port.close()
        ref.close()


# --------------------------------------------------------------------------
# warming, lifecycle, admission errors
# --------------------------------------------------------------------------

def test_warm_and_warmed_plans():
    region, ref_region = _hinge_pair()
    port, ref = _servers(workers=0, max_batch=4, pad_to=32,
                         autostart=False)
    X, w, y = _hinge_args(30)
    ops = {"X": X, "w": w, "y": y}
    report = port.warm([(region, ops)], execute=True, batch_sizes=(1, 4))
    want = ref.warm([(ref_region, ops)], execute=True, batch_sizes=(1, 4))
    assert len(report["entries"]) == len(want["entries"]) == 1
    ent, rent = report["entries"][0], want["entries"][0]
    assert (ent["batchable"], ent["pad_safe"]) == \
        (rent["batchable"], rent["pad_safe"]) == (True, True)
    assert ent["digest"] and ent["label"] == rent["label"]
    assert report["whole_plan_cache"]["capacity"] > 0
    assert set(report["whole_plan_cache"]) == set(want["whole_plan_cache"])
    plans = port.warmed_plans()
    assert len(plans) == 1
    label, planned = plans[0]
    assert "[" in label and "x" in label
    assert planned.eplan is not None
    with pytest.raises(ServerClosedError):
        port.submit(region, X, w, y)
    with pytest.raises(Exception) as ei:
        ref.submit(ref_region, X, w, y)
    assert type(ei.value).__name__ == "ServerClosedError"


def test_drain_serves_a_started_server_without_workers():
    """The port's own: a ``workers=0`` server admits once started and
    serves in the caller's thread at ``drain()``: the requests of one
    class queued before the call are one batch, two classes two, and
    the results equal the reference's batch and the direct calls."""
    region, ref_region = _hinge_pair()
    ms = (20, 31, 40)
    cases = [_hinge_args(m) for m in ms]
    port = FusionServer(context=CTX, workers=0, max_batch=4, pad_to=32)
    ref = RefServer(workers=1, max_batch=4, pad_to=32, autostart=False)
    ref._started = True
    try:
        port.start()
        assert not port._threads
        futs = [(port.submit(region, *a), ref.submit(ref_region, *a))
                for a in cases]
        assert not any(f.done() for f, _rf in futs)
        assert port.drain() == 2 and port.drain() == 0
        _drain(ref)
        for m, args, (f, rf) in zip(ms, cases, futs):
            got, want = f.result(timeout=0), rf.result(timeout=300)
            assert tuple(got.shape) == want.shape == (m, 1)
            _parity(got, want)
            _parity(got, _direct(region, *args))
        snap = port.metrics.snapshot()
        assert snap["batches"]["count"] == 2
        assert snap["batches"]["occupancy_max"] == 2
        assert snap["requests"]["completed"] == 3
    finally:
        port.close()
        ref.close()


def test_submit_typed_errors():
    region, ref_region = _hinge_pair()
    X, w, y = _hinge_args(20)
    port, ref = _servers(workers=1, max_batch=2, pad_to=32)
    try:
        for s, r in ((port, region), (ref, ref_region)):
            # the port raises its own taxonomy; the reference its own
            err = FusionServeError if s is port else Exception
            with pytest.raises(err):
                s.submit(object(), X)              # not a fused region
            with pytest.raises(err) as ei:
                s.submit(r, X, w)                  # missing operand
            assert "missing" in str(ei.value)
            with pytest.raises(err):
                s.submit(r, X=X, w=w, z=y)         # unknown name
            with pytest.raises(err):
                s.submit(r, X, w, "nope")          # not an array
            with pytest.raises(err):
                s.submit(r, X[None], w, y)         # 3-D operand
        snaps = [s.metrics.snapshot()["requests"] for s in (port, ref)]
        assert snaps[0] == snaps[1]
        assert snaps[0]["rejected"] == 5 and snaps[0]["submitted"] == 0
    finally:
        port.close()
        ref.close()
    with pytest.raises(ServerClosedError):
        port.submit(region, X, w, y)


def test_metrics_snapshot_and_report_shape():
    region, ref_region = _hinge_pair()
    port, ref = _servers(workers=1, max_batch=4, pad_to=32)
    try:
        args = _hinge_args(25)
        port.submit(region, *args).result(timeout=300)
        ref.submit(ref_region, *args).result(timeout=300)
        snap, rsnap = port.metrics.snapshot(), ref.metrics.snapshot()
        assert set(snap) == set(rsnap)
        for key in ("requests", "latency_us", "batches", "queue",
                    "compiles", "buckets", "cache"):
            assert key in snap, key
        assert snap["latency_us"]["count"] == 1
        assert snap["latency_us"]["p99"] >= snap["latency_us"]["p50"] > 0
        for cache in ("plan", "whole_plan"):
            assert set(snap["cache"][cache]) == set(rsnap["cache"][cache])
        doc = port.metrics.report(port)
        assert doc["server"]["max_batch"] == 4
        assert doc["server"]["entries"] == 1
        assert isinstance(doc["serving"]["cache"]["whole_plan_keys"], list)
        assert set(doc["server"]) == set(ref.metrics.report(ref)["server"])
    finally:
        port.close()
        ref.close()


def test_context_manager_closes():
    region, _ref_region = _hinge_pair()
    args = _hinge_args(20)
    with FusionServer(workers=1, max_batch=2, pad_to=32,
                      context=CTX) as server:
        _parity(server.submit(region, *args).result(timeout=300),
                _direct(region, *args))
    assert server._closed and not server._threads
