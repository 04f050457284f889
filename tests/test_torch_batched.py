"""The request axis: ``Compiled.batched()`` against the reference's
``jit(vmap(plan_fn))``, the structural plan key the server buckets by,
and the request-axis form of the Cell, Row and MAgg kernels as far as the
CPU can check it (every generated source parses against the CUDA stub;
the per-request strides, the ticket layout and the shared-out grid as
constants).  On the CPU a batched fused step runs the plain versions (the
oracle per request); the card's launches are checked by
``chip_smoke.py``'s ``[batch]`` phase.
"""

import re
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused as ref_fused
from repro.core import ir as ref_ir
from repro_torch.core import FusionContext, fused, ir
from repro_torch.kernels import build, cellwise, cuda_src, sweep

from test_torch_cell_layout import _parse

TOL = 1e-5


def _hinge(ir):
    return lambda X, w, y: ir.relu(1.0 - y * (X @ w))


def _probs(ir):
    def probs(X, W):
        E = ir.exp(X @ W)
        return E / E.rowsums()
    return probs


def _sum_sq(ir):
    return lambda X: (X * X).sum()


def _two_sums(ir):
    return lambda X, Y: ((X * Y).sum(), (X ** 2).sum())


#: name -> (expression builder, operand shapes at m rows)
REGIONS = {
    "hinge": (_hinge, lambda m: {"X": (m, 16), "w": (16, 1),
                                 "y": (m, 1)}),
    "probs": (_probs, lambda m: {"X": (m, 16), "W": (16, 5)}),
    "sum_sq": (_sum_sq, lambda m: {"X": (m, 8)}),
    "two_sums": (_two_sums, lambda m: {"X": (m, 8), "Y": (m, 8)}),
}


def _stacked(shapes, nreq, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(nreq,) + s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("kernels", ["never", "cuda"])
@pytest.mark.parametrize("nreq", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(REGIONS))
def test_batched_matches_the_reference_vmap(name, nreq, kernels):
    expr, shapes_at = REGIONS[name]
    shapes = shapes_at(40)
    port = fused(expr(ir)).trace(
        **{k: torch.empty(s, device="meta") for k, s in shapes.items()}
    ).plan(context=FusionContext(device="cpu", kernels=kernels)).compile()
    ref = ref_fused(expr(ref_ir)).trace(
        **{k: np.zeros(s, np.float32) for k, s in shapes.items()}
    ).plan().compile(pallas="never")
    assert port.input_order == ref.input_order
    vals = _stacked(shapes, nreq, seed=nreq)
    order = port.input_order
    got = port.batched()(*[torch.as_tensor(vals[k]) for k in order])
    want = ref.batched()(*[jnp.asarray(vals[k]) for k in order])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.shape[0] == nreq
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    # and request by request, the single-request staged call
    for q in range(nreq):
        one = port(**{k: torch.as_tensor(vals[k][q]) for k in order})
        one = one if isinstance(one, tuple) else (one,)
        for g, o in zip(got, one):
            np.testing.assert_allclose(g[q].numpy(), o.detach().numpy(),
                                       rtol=TOL, atol=TOL)


def test_batched_fused_steps_take_the_request_axis_dispatch(monkeypatch):
    """Every fused step of the batched plan function goes through
    ``ops.execute_batched`` once per batch, never per request."""
    from repro_torch.kernels import ops
    calls = []
    orig = ops.execute_batched
    monkeypatch.setattr(ops, "execute_batched",
                        lambda cp, env, kernels: calls.append(cp.ttype)
                        or orig(cp, env, kernels=kernels))
    shapes = REGIONS["probs"][1](24)
    compiled = fused(_probs(ir)).trace(
        **{k: torch.empty(s, device="meta") for k, s in shapes.items()}
    ).plan(context=FusionContext(device="cpu")).compile()
    n_fused = len(compiled._cplan.cplans())
    vals = _stacked(shapes, 4, seed=0)
    compiled.batched()(*[torch.as_tensor(vals[k])
                         for k in compiled.input_order])
    assert len(calls) == n_fused >= 1


def test_plan_key_is_structural_as_in_the_reference():
    shapes = {"X": (64, 16), "w": (16, 1), "y": (64, 1)}

    def keys(fused_, ir_, plan_ctx, compile_kw):
        meta = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
        out = []
        for fn in (lambda X, w, y: ir_.relu(1.0 - y * (X @ w)),
                   lambda X, w, y: ir_.relu(1.0 - y * (X @ w)),
                   lambda X, w, y: ir_.relu(2.0 - y * (X @ w))):
            planned = fused_(fn).trace(**meta).plan(**plan_ctx)
            out.append(planned.compile(**compile_kw).plan_key())
        return out

    port = keys(fused, ir, {"context": FusionContext(device="cpu")}, {})
    ref = keys(ref_fused, ref_ir, {}, {"pallas": "never"})
    for k in (port, ref):
        assert k[0] == k[1] and k[0] != k[2]
        assert hash(k[0]) == hash(k[1])


# --------------------------------------------------------------------------
# the request-axis kernels, CPU side
# --------------------------------------------------------------------------

KERNEL_CASES = [c for c in sweep.cases()
                if c.template in ("cell", "row", "magg")]


def _sources(case):
    out = []
    for m, n in ((33, 7), (33, 1), (2_000_003, 100)):
        if n >= case.min_n:
            out.append(cuda_src.source_for(sweep.fused_cplan(case, m, n)[0]))
    return out


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in KERNEL_CASES])
def test_request_axis_sources_parse(case, tmp_path):
    """Every Cell, Row and MAgg sweep source, with its request-axis
    launcher, parses against the CUDA stub."""
    srcs = {s.key: s for s in _sources(case)}.values()
    for src in srcs:
        assert cuda_src.LAUNCH_SIGNATURE in src.text
    for key, rc, err in _parse(srcs, tmp_path):
        assert rc == 0, f"{case.name} {key}:\n{err}"


def test_launcher_abi_matches_the_generated_signature():
    params = cuda_src.LAUNCH_SIGNATURE.split("(", 1)[1].rstrip(")")
    assert len(params.split(",")) == len(build._ARGTYPES["repro_launch"])
    assert "const long long* strides, int nreq" in params
    for header in ("cell.cuh", "row.cuh", "magg.cuh"):
        text = (build.CSRC / header).read_text()
        kernels = re.findall(r"__global__ void[^;{]*\n(\w+)\(rk::(\w+)<", text)
        assert kernels and all(b == "BBinds" for _k, b in kernels), header
        assert text.count("bb.at(blockIdx.z)") == len(kernels), header


@pytest.mark.parametrize("shape,stride", [((5, 3), 16), ((4, 4), 16),
                                          ((7, 1), 8), ((1, 1), 4),
                                          ((128, 64), 8192)])
def test_batch_stride_keeps_every_request_16_byte_aligned(shape, stride):
    assert build.batch_stride(shape) == stride
    t = build.batch_empty(3, shape, "cpu")
    assert tuple(t.shape) == (3,) + shape
    assert t.stride() == (stride, shape[1], 1)
    assert all(t[q].is_contiguous() for q in range(3))
    assert build.batch_aligned(t)
    dense = torch.zeros((3,) + shape)
    assert build.batch_aligned(dense) == (shape[0] * shape[1] % 4 == 0)


def test_grid_is_shared_out_over_the_requests():
    assert build.share(528, 1) == 528
    assert build.share(528, 8) == 66
    assert build.share(5, 8) == 1
    case = next(c for c in sweep.cases() if c.name == "cell/no_agg")
    src = cuda_src.source_for(sweep.fused_cplan(case, 10_000_000, 1)[0])
    one = cellwise.grid(src, 10_000_000, 132)
    assert one == 132 * src.ctas
    assert cellwise.grid(src, 10_000_000, 132, 8) == -(-one // 8)
    assert cellwise.grid(src, 100, 132, 8) == 1


def test_ticket_layout_is_one_word_per_request():
    assert [cellwise.ticket_words(q) for q in (1, 3, 4, 5, 8, 9)] == \
        [4, 4, 4, 8, 8, 12]


def test_scratch_is_keyed_per_device_and_stream():
    """One buffer per (device, stream) key, zeroed when made, grown (not
    cleared) when a call needs more tickets or partials; threads racing
    on one key share one buffer."""
    cpu = torch.device("cpu")
    a, head = cellwise.scratch(cpu, 100, 3, key=("test", 1))
    assert head == 4 and a.numel() >= head + 100 and not a.any()
    b, _ = cellwise.scratch(cpu, 100, 3, key=("test", 2))
    assert b.data_ptr() != a.data_ptr()
    a[0] = 7.0                                 # a ticket left by a kernel
    again, _ = cellwise.scratch(cpu, 50, 1, key=("test", 1))
    assert again is a and again[0] == 7.0      # never cleared by a call
    grown, head = cellwise.scratch(cpu, 10, 9, key=("test", 1))
    assert head == 12 and grown is not a and not grown.any()
    got = []
    barrier = threading.Barrier(8)

    def take():
        barrier.wait()
        got.append(cellwise.scratch(cpu, 1 << 17, 2, key=("test", 3))[0])

    threads = [threading.Thread(target=take) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({t.data_ptr() for t in got}) == 1
    for k in [k for k in cellwise._SCRATCH if k[0] == "test"]:
        del cellwise._SCRATCH[k]
