"""CLA compression in the port against the JAX reference.

``DictCompressed`` (per-column dictionaries, codes and counts) must give
the reference's arrays bit for bit, and the CLA fast path
``ops._execute_dict`` (``Σ f(distinct) · count``) must qualify exactly the
CPlans the reference's does and agree with it; a CPlan it refuses is
densified and re-dispatched on the dense paths, as in the reference.  The
reference runs as its own tests run it (XLA, ``pallas="never"``); the port
runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused as ref_fused
from repro.core import ir as ref_ir
from repro.kernels import blocksparse as rbs
from repro.kernels import ops as ref_ops
from repro_torch.core import FusionContext, fused, ir
from repro_torch.interop import to_dict_compressed
from repro_torch.kernels import ops, sweep
from repro_torch.kernels.blocksparse import DictCompressed
from torch_harness import reference_cplan

TOL = 1e-5
CTX = FusionContext(device="cpu", kernels="never")


def _quantized(m, n, levels=9, seed=0):
    """(m, n) fp32 with at most ``levels`` distinct values per column."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-(levels // 2), levels // 2 + 1, size=(m, n))
    return (q * 0.375 + rng.normal(size=(1, n)).round(2)).astype(np.float32)


def _same(port: DictCompressed, ref) -> None:
    for name in ("values", "codes", "counts"):
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert port.shape == tuple(ref.shape)


# --------------------------------------------------------------------------
# the format
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,levels", [(500, 6, 9), (97, 1, 2),
                                        (64, 13, 40), (1, 3, 1)])
def test_from_dense_matches_reference_bit_for_bit(m, n, levels):
    x = _quantized(m, n, levels, seed=m + n)
    port, ref = DictCompressed.from_dense(x), rbs.DictCompressed.from_dense(x)
    _same(port, ref)
    np.testing.assert_array_equal(port.todense().numpy(),
                                  np.asarray(ref.todense()))
    np.testing.assert_array_equal(port.todense().numpy(), x)
    assert port.compression_ratio == ref.compression_ratio


def test_from_dense_takes_tensors_and_refuses_wide_columns_like_reference():
    x = _quantized(300, 4, levels=21, seed=7)
    _same(DictCompressed.from_dense(torch.as_tensor(x)),
          rbs.DictCompressed.from_dense(x))
    with pytest.raises(ValueError) as ref_err:
        rbs.DictCompressed.from_dense(x, max_distinct=10)
    with pytest.raises(ValueError) as port_err:
        DictCompressed.from_dense(x, max_distinct=10)
    assert str(port_err.value) == str(ref_err.value)


def test_to_dict_compressed_carries_the_reference_object():
    x = _quantized(200, 5, seed=3)
    ref = rbs.DictCompressed.from_dense(x)
    port = to_dict_compressed(ref, "cpu")
    _same(port, ref)
    assert to_dict_compressed(port, "cpu") is port
    np.testing.assert_array_equal(port.todense().numpy(), x)


# --------------------------------------------------------------------------
# the CLA fast path, CPlan by CPlan
# --------------------------------------------------------------------------

def _case(name, expr, operands, want=None):
    return sweep.Case(name, "cell", expr, operands, want)


#: (case, does the reference's CLA path take it)
CLA_CASES = [
    (_case("sum_sq", lambda ir, X: (X ** 2).sum(), ("X",), "CELL"), True),
    (_case("affine_sum", lambda ir, X: (ir.abs_(X) * 2.0 + 1.0).sum(),
           ("X",), "CELL"), True),
    (_case("side_matrix", lambda ir, X, Y: (X * Y).sum(), ("X", "Y"),
           "CELL"), False),
    (_case("not_sum", lambda ir, X: (X * 3.0).max_(), ("X",), "CELL"),
     False),
    (_case("mean", lambda ir, X: (X ** 2).mean(), ("X",), "CELL"), False),
    (_case("extra", lambda ir, X: ((X ** 2).sum(), ir.abs_(X).sum()),
           ("X",), None), False),
    (_case("row_agg", lambda ir, X: (X ** 2).rowsums(), ("X",), "CELL"),
     False),
    (_case("no_agg", lambda ir, X: ir.exp(X * 0.5), ("X",), None), False),
]


@pytest.mark.parametrize("case,qualifies", [
    pytest.param(c, q, id=c.name) for c, q in CLA_CASES])
def test_execute_dict_qualifies_as_the_reference_and_agrees(case,
                                                            qualifies):
    m, n = 257, 6
    cp, names = sweep.fused_cplan(case, m, n)
    rcp, rnames = reference_cplan(case, m, n)
    assert [rnames[b.nid] for b in rcp.binds] == \
        [names[b.nid] for b in cp.binds]
    rng = np.random.default_rng(11)
    vals = {k: (_quantized(*s, seed=5) if k == "X"
                else rng.normal(size=s).astype(np.float32))
            for k, s in case.shapes(m, n).items()}
    ref_X = rbs.DictCompressed.from_dense(vals["X"])
    renv = {b.nid: (ref_X if rnames[b.nid] == "X"
                    else jnp.asarray(vals[rnames[b.nid]]))
            for b in rcp.binds}
    env = {b.nid: (DictCompressed.from_dense(vals["X"])
                   if names[b.nid] == "X"
                   else torch.as_tensor(vals[names[b.nid]]))
           for b in cp.binds}
    want = ref_ops._execute_dict(rcp, renv)
    got = ops._execute_dict(cp, env)
    assert (want is not None) == qualifies
    assert (got is not None) == qualifies
    if qualifies:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    # the full dispatch: the CLA path or todense() and the dense paths,
    # under either kernel policy (the CPU runs the plain versions)
    ref_out = np.asarray(ref_ops.execute(rcp, renv))
    for kernels in ("never", "cuda"):
        out = ops.execute(cp, env, kernels=kernels)
        np.testing.assert_allclose(out.numpy(), ref_out, rtol=TOL, atol=TOL)


def test_densified_main_equals_the_dense_call():
    """A refused CPlan runs on ``todense()`` of the main: exactly the
    dense call's result, not merely close to it."""
    case = CLA_CASES[2][0]
    cp, names = sweep.fused_cplan(case, 120, 5)
    x = _quantized(120, 5, seed=9)
    y = np.random.default_rng(2).normal(size=(120, 5)).astype(np.float32)
    dense = {b.nid: torch.as_tensor(x if names[b.nid] == "X" else y)
             for b in cp.binds}
    comp = {nid: (DictCompressed.from_dense(x) if names[nid] == "X" else v)
            for nid, v in dense.items()}
    assert ops._execute_dict(cp, comp) is None
    assert torch.equal(ops.execute(cp, comp), ops.execute(cp, dense))


# --------------------------------------------------------------------------
# staged regions over a compressed operand
# --------------------------------------------------------------------------

REGIONS = {
    "sum_sq": (lambda ir, X: (X ** 2).sum(), ("X",)),
    "scaled_sum": (lambda ir, X, lam: (ir.abs_(X) * lam).sum(),
                   ("X", "lam")),
    "side": (lambda ir, X, w: ((X @ w) ** 2).sum(), ("X", "w")),
    "two_sums": (lambda ir, X: ((X ** 2).sum(), (X * 0.5).sum()), ("X",)),
}


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_staged_region_over_a_compressed_operand_matches_reference(name):
    expr, args = REGIONS[name]
    m, n = 300, 8
    x = _quantized(m, n, seed=13)
    rng = np.random.default_rng(4)
    shapes = {"X": (m, n), "w": (n, 1), "lam": (1, 1)}
    vals = {k: (x if k == "X" else
                rng.normal(size=shapes[k]).astype(np.float32))
            for k in args}
    names = ", ".join(args)
    port_fn = fused(eval(f"lambda {names}: expr(ir, {names})",
                         {"expr": expr, "ir": ir}))
    ref_fn = ref_fused(eval(f"lambda {names}: expr(ir, {names})",
                            {"expr": expr, "ir": ref_ir}))
    ref_args = [rbs.DictCompressed.from_dense(v) if k == "X"
                else jnp.asarray(v) for k, v in vals.items()]
    port_args = [DictCompressed.from_dense(v) if k == "X" else v
                 for k, v in vals.items()]
    want = ref_fn(*ref_args)
    with CTX:
        got = port_fn(*port_args)
        dense = port_fn(*vals.values())
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    dense = dense if isinstance(dense, tuple) else (dense,)
    for g, w, d in zip(got, want, dense):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=TOL,
                                   atol=TOL)
    traced = port_fn.trace(*port_args)
    assert traced.in_meta["X"]["format"] == "dict"


def test_compressed_operand_is_served_per_request():
    """The server classes a DictCompressed operand as ``dict``: served
    unbatched, at the exact-shape tier, equal to the direct call and to
    the reference's direct call."""
    from repro_torch.serve import FusionServer
    port_fn = fused(lambda X: (X ** 2).sum())
    ref_fn = ref_fused(lambda X: (X ** 2).sum())
    xs = [_quantized(96, 5, seed=s) for s in (1, 2)]
    with FusionServer(workers=1, max_batch=4, pad_to=32,
                      context=CTX) as server:
        futs = [server.submit(port_fn, DictCompressed.from_dense(x))
                for x in xs]
        for x, f in zip(xs, futs):
            got = f.result(timeout=300)
            want = ref_fn(rbs.DictCompressed.from_dense(x))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
        snap = server.metrics.snapshot()
    assert snap["batches"]["batched_requests"] == 0
    assert snap["requests"]["completed"] == 2
