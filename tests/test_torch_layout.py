"""Hybrid local/distributed planning parity: under an abstract mesh the
port's planner selects exactly the reference's plans — placements,
collective epilogues and volumes, segments, costs and the
``explain()["distributed"]`` report — for every planning case of
``tests/test_dist_exec.py``, on ``LogicalMesh({"data": 8})`` (and 1 and
16), and runs them locally to the reference's numbers.

Tolerances: plans, placements, segments and the layout / distributed
reports must be *equal*, costs to 12 significant digits (the same copied
arithmetic, but some sums run over sets of node ids, whose order follows
each package's own id counter); executed values 1e-5 (fp32, as in
``tests/test_dist_exec.py``).  Partition specs are normalised: the
reference's ``PartitionSpec`` and the port's tuple both become tuples,
and node ids become positions in the graph.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import l2svm as ref_l2svm
from repro.algos import mlogreg as ref_mlogreg
from repro.core import FusionContext as RefContext
from repro.core import fused as ref_fused
from repro.core import ir as ref_ir
from repro.core.layout import FusionLayout as RefLayout
from repro.core.layout import ensure_layout as ref_ensure_layout
from repro.core.layout import layout_cost_params as ref_cost_params
from repro.dist import sharding as ref_sharding
from repro.dist.planner import LogicalMesh as RefMesh
from repro_torch.algos import l2svm, mlogreg
from repro_torch.core import FusionContext, fused, ir
from repro_torch.core.layout import (FusionLayout, ensure_layout,
                                     layout_cost_params)
from repro_torch.core.templates import TType, dist_epilogue
from repro_torch.dist import LogicalMesh, sharding, signature_of
from repro_torch.interop import to_layout

torch.set_num_threads(1)

DIST_GOLDEN = Path(__file__).parent / "golden" / "explain_mlogreg_dist.json"
CPU = FusionContext(device="cpu", kernels="never")
rng = np.random.default_rng(7)


def _mlogreg_spec(m=10_000, n=100, k=5):
    return dict(X=np.zeros((m, n), np.float32),
                B=np.zeros((n, k), np.float32),
                Y=np.zeros((m, k), np.float32),
                lam=np.zeros((1, 1), np.float32))


def _l2svm_spec():
    return dict(X=np.zeros((10_000, 100), np.float32),
                w=np.zeros((100, 1), np.float32),
                y=np.zeros((10_000, 1), np.float32),
                lam=np.zeros((1, 1), np.float32))


def _segment_expr(ir_):
    def expr(X1, X2, X3, X4, X5, X6, w):
        A = ir_.sigmoid(X1 + X2 + X3 + X4 + X5 + X6)
        return ((A * X1 + X2).sum(), (A - X3).rowsums(),
                (A * A + X4).sum(), (w ** 2).sum())
    return expr


def _segment_spec():
    return [np.zeros((4096, 64), np.float32) for _ in range(6)] + \
        [np.zeros((10, 1), np.float32)]


def _plans(ref_region, port_region, args, n, **kw):
    """(reference Planned, port Planned) of one region on a data-n mesh."""
    ref = ref_region.trace(*args.get("pos", ()), **args.get("kw", {})) \
        .plan(mode="gen", layout=RefMesh({"data": n}), **kw)
    with CPU:
        port = port_region.trace(*args.get("pos", ()),
                                 **args.get("kw", {})) \
            .plan(mode="gen", layout=LogicalMesh({"data": n}), **kw)
    return ref, port


def _norm(report: dict) -> dict:
    """The report as JSON would carry it (tuples → lists), without the
    execution section's per-package keys (the reference's jit dispatch
    count and staging flag, the port's kernel policy and device)."""
    out = json.loads(json.dumps(report, sort_keys=True, default=list),
                     parse_float=_r)
    ex = out.pop("execution")
    out["fallbacks"] = ex["fallbacks"]
    out["freed_intermediates"] = ex["freed_intermediates"]
    return out


def _r(x) -> float:
    """A cost to 12 significant digits."""
    return float(f"{float(x):.12g}")


def _pos(graph) -> dict:
    """nid → position in the graph's node order: node ids are counters of
    each package, so they differ between the two; positions do not."""
    return {n.nid: i for i, n in enumerate(graph.nodes)}


def _dist_sig(dist, graph) -> tuple:
    """DistParams.signature() with the input nids as positions."""
    pos = _pos(graph)
    axes, n, bw, rows, cols = dist.signature()
    return (axes, n, bw, tuple(sorted((pos[k], v) for k, v in rows)),
            tuple(sorted((pos[k], v) for k, v in cols)))


def _placements(planned):
    return [(o["template"], o.get("placement"))
            for o in planned.explain()["winner"]["operators"]]


# --------------------------------------------------------------------------
# the layout rules and the cost geometry
# --------------------------------------------------------------------------

MESHES = ({"data": 8}, {"data": 1}, {"data": 16}, {"data": 4, "model": 2},
          {"pod": 2, "data": 4, "model": 4})
SHAPES = ((10_000, 100), (100, 5), (1, 100), (1, 1), (1000, 10), (64, 64),
          (4096, 64), (10, 1), (12, 8))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{a}{n}" for a, n in m.items()))
def test_operand_spec_matches_reference(mesh, shape):
    ref = ref_sharding.operand_spec(RefMesh(mesh), shape)
    port = sharding.operand_spec(LogicalMesh(mesh), shape)
    assert isinstance(port, tuple)
    assert tuple(ref) == port
    assert signature_of(LogicalMesh(mesh)) == signature_of(mesh)


@pytest.mark.parametrize("n", [1, 8, 16])
def test_layout_and_cost_geometry_match_reference(n):
    """FusionLayout.auto, its shard factors and row group, and the
    DistParams layout_cost_params derives equal the reference's; the
    interop converter carries a reference layout across unchanged."""
    spec = _mlogreg_spec()
    graph_ref = ref_mlogreg._nll_obj_reg.trace(**spec).graph
    with CPU:
        graph = mlogreg._nll_obj_reg.trace(**spec).graph
    shapes = {k: v.shape for k, v in spec.items()}
    rlay = RefLayout.auto(RefMesh({"data": n}), shapes)
    lay = FusionLayout.auto(LogicalMesh({"data": n}), shapes)
    assert to_layout(rlay).key() == lay.key()
    assert {k: tuple(v) for k, v in rlay.specs.items()} == lay.specs
    for name in shapes:
        assert rlay.shard_factors(name) == lay.shard_factors(name)
    assert (rlay.row_axes(), rlay.row_devices()) == \
        (lay.row_axes(), lay.row_devices())
    from repro.core.cost import TPU_V5E as REF_V5E
    from repro_torch.core.cost import TPU_V5E
    rp = ref_cost_params(rlay, graph_ref, REF_V5E)
    pp = layout_cost_params(lay, graph, TPU_V5E)
    assert (rp.dist is None) == (pp.dist is None) == (n == 1)
    if n > 1:
        assert _dist_sig(rp.dist, graph_ref) == _dist_sig(pp.dist, graph)
    pos_ref, pos = _pos(graph_ref), _pos(graph)
    assert {pos_ref[k]: v for k, v in rp.input_read_bw.items()} == \
        {pos[k]: v for k, v in pp.input_read_bw.items()}
    # a bare mesh auto-fits to the graph's inputs and outputs
    assert ensure_layout(LogicalMesh({"data": n}), graph).key() == \
        to_layout(ref_ensure_layout(RefMesh({"data": n}), graph_ref)).key()


def test_dist_variant_registry():
    """The distributed variants of the copied template registry: the
    reference's table (tests/test_dist_exec.py::test_dist_variant_registry)."""
    assert dist_epilogue(TType.CELL, "no_agg", "") == "none"
    assert dist_epilogue(TType.ROW, "row_agg", "sum") == "none"
    assert dist_epilogue(TType.MAGG, "full_agg", "sum") == "psum"
    assert dist_epilogue(TType.ROW, "col_t_agg", "sum") == "psum"
    assert dist_epilogue(TType.OUTER, "left_mm", "sum") == "psum"
    assert dist_epilogue(TType.CELL, "full_agg", "min") == "pmin"
    assert dist_epilogue(TType.CELL, "full_agg", "max") == "pmax"
    assert dist_epilogue(TType.CELL, "full_agg", "mean") is None
    assert dist_epilogue(TType.MAGG, "no_agg", "sum") is None


# --------------------------------------------------------------------------
# hybrid plan selection: every planning case of tests/test_dist_exec.py
# --------------------------------------------------------------------------

def _cases():
    sq = (ref_fused(lambda X, w: (X @ w).sum()),
          fused(lambda X, w: (X @ w).sum()),
          {"kw": dict(X=np.zeros((64, 64), np.float32),
                      w=np.zeros((64, 1), np.float32))})
    indiv = (ref_fused(lambda X, y: ref_ir.relu(1.0 - y * X).sum()),
             fused(lambda X, y: ir.relu(1.0 - y * X).sum()),
             {"kw": dict(X=np.zeros((1000, 10), np.float32),
                         y=np.zeros((1000, 1), np.float32))})
    return {
        "mlogreg/nll_obj_reg": (ref_mlogreg._nll_obj_reg,
                                mlogreg._nll_obj_reg,
                                {"kw": _mlogreg_spec()}),
        "l2svm/objective_full": (ref_l2svm._objective_full,
                                 l2svm._objective_full,
                                 {"kw": _l2svm_spec()}),
        "square_main": sq,
        "indivisible_rows": indiv,
        "segment_program": (ref_fused(_segment_expr(ref_ir)),
                            fused(_segment_expr(ir)),
                            {"pos": _segment_spec()}),
    }


@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_plan_and_explain_match_reference(case, n):
    """Plans, placements, epilogues, collective volumes, segments, costs,
    the candidates table, the layout and distributed reports, the
    verifier's summary and the static fallbacks equal the reference's,
    forward and planned backward."""
    ref_region, port_region, args = _cases()[case]
    ref, port = _plans(ref_region, port_region, args, n)
    assert _norm(port.explain()) == _norm(ref.explain())
    assert [s.indices for s in port.eplan.segments] == \
        [s.indices for s in ref.eplan.segments]
    pp, pr = _pos(port.eplan.graph), _pos(ref.eplan.graph)
    for a, b in zip(port.eplan.segments, ref.eplan.segments):
        assert (a.axes, a.n, a.removed_gather_bytes) == \
            (b.axes, b.n, b.removed_gather_bytes)
        assert [(i, j, pp[nid]) for i, j, nid in a.sharded_edges] == \
            [(i, j, pr[nid]) for i, j, nid in b.sharded_edges]
    for sa, sb in zip(port.eplan.fused_specs(), ref.eplan.fused_specs()):
        pa, pb = getattr(sa, "placement", None), getattr(sb, "placement",
                                                         None)
        assert (pa is None) == (pb is None)
        if pa is not None:
            assert (pa.arm, pa.epilogue, pa.axes, pa.n,
                    {pp[nid] for nid in pa.sharded}) == \
                (pb.arm, pb.epilogue, pb.axes, pb.n,
                 {pr[nid] for nid in pb.sharded})
            for x, y in ((pa.cost, pb.cost), (pa.local_cost, pb.local_cost),
                         (pa.dist_cost, pb.dist_cost),
                         (pa.collective_bytes, pb.collective_bytes),
                         (pa.gather_bytes, pb.gather_bytes)):
                assert _r(x) == _r(y)
    if case in ("mlogreg/nll_obj_reg", "l2svm/objective_full"):
        rb, pb = ref.explain(include_backward=True)["backward"], \
            port.explain(include_backward=True)["backward"]
        assert json.loads(json.dumps(pb), parse_float=_r) == \
            json.loads(json.dumps(rb), parse_float=_r)


def test_mlogreg_selects_hybrid_plan():
    """On a 1×8 abstract mesh the regularized-NLL objective splits: the
    X-row-parallel chain distributes, the B-space multi-aggregate stays
    local."""
    ref_region, port_region, args = _cases()["mlogreg/nll_obj_reg"]
    _ref, planned = _plans(ref_region, port_region, args, 8)
    report = planned.explain()
    ops = report["winner"]["operators"]
    assert {o["placement"] for o in ops} == {"local", "distributed"}, ops
    dist_ops = [o for o in ops if o["placement"] == "distributed"]
    assert all(o["epilogue"] in ("none", "psum", "pmin", "pmax")
               for o in dist_ops)
    assert any(o["collective_bytes"] > 0 for o in dist_ops)
    assert report["distributed"]["devices"] == 8
    assert report["distributed"]["n_fused_distributed"] >= 1
    assert report["distributed"]["n_fused_local"] >= 1


def test_square_main_keeps_matmul_operand_replicated():
    """Row alignment is template-semantic: with a square X, w in
    (X @ w).sum() is the matmul's right operand and is not row-sharded;
    the plan executes locally to the exact sum."""
    ref_region, port_region, args = _cases()["square_main"]
    _ref, planned = _plans(ref_region, port_region, args, 8)
    g = planned.eplan.graph
    w_nid = next(n.nid for n in g.inputs() if n.name == "w")
    for s in planned.eplan.fused_specs():
        pl = s.placement
        if pl is not None and pl.arm == "distributed":
            assert w_nid not in pl.sharded
    out = planned.compile()(torch.ones((64, 64)), torch.ones((64, 1)))
    assert float(out[0, 0]) == 64.0 * 64.0


def test_indivisible_rows_stay_local():
    ref_region, port_region, args = _cases()["indivisible_rows"]
    _ref, planned = _plans(ref_region, port_region, args, 16)
    assert all(pl == "local" for _, pl in _placements(planned))


def test_placement_changes_with_mesh_width():
    """The same trace plans all-local on a 1-device mesh and hybrid on an
    8-device one, and the modeled mesh-wide plan is cheaper."""
    ref_region, port_region, args = _cases()["mlogreg/nll_obj_reg"]
    _r1, one = _plans(ref_region, port_region, args, 1)
    _r8, eight = _plans(ref_region, port_region, args, 8)
    assert all(pl is None or pl == "local" for _, pl in _placements(one))
    assert any(pl == "distributed" for _, pl in _placements(eight))
    assert eight.cost < one.cost


def test_segment_annotation_abstract_mesh():
    """The 6-operand program plans one segment of ≥ 2 adjacent operators
    with a row-sharded edge and removed boundary volume, as the
    reference's; on the abstract mesh it runs locally with the reason
    recorded."""
    ref_region, port_region, args = _cases()["segment_program"]
    _ref, planned = _plans(ref_region, port_region, args, 8)
    segs = planned.eplan.segments
    assert len(segs) == 1 and len(segs[0].indices) >= 2
    assert segs[0].removed_gather_bytes > 0 and segs[0].sharded_edges
    ix = segs[0].indices
    assert list(ix) == list(range(ix[0], ix[-1] + 1))
    fbs = planned.explain()["execution"]["fallbacks"]
    assert fbs and all("abstract mesh" in f["reason"] for f in fbs)


def test_explain_golden_mlogreg_dist():
    """The reference's golden hybrid report (tests/golden/
    explain_mlogreg_dist.json) is the port's too, but for the execution
    section's per-package keys."""
    ref_region, port_region, args = _cases()["mlogreg/nll_obj_reg"]
    _ref, planned = _plans(ref_region, port_region, args, 8)
    report = planned.explain()
    report["winner"]["cost"] = round(report["winner"]["cost"], 12)
    for c in report["candidates"]:
        c["cost"] = round(c["cost"], 12)
    expected = json.loads(DIST_GOLDEN.read_text())
    assert _norm(report) == _norm(expected)


def test_context_layout_scoping_and_key():
    """A bare mesh scoped through the context auto-fits per trace as
    ``plan(layout=)`` does; the layout enters the context key, and an
    abstract mesh's key differs from no layout."""
    spec = _mlogreg_spec()
    mesh = LogicalMesh({"data": 8})
    with CPU.with_(layout=mesh):
        scoped = mlogreg._nll_obj_reg.trace(**spec).plan().explain()
    with CPU:
        direct = mlogreg._nll_obj_reg.trace(**spec).plan(
            layout=mesh).explain()
    assert _norm(scoped) == _norm(direct)
    assert CPU.key() != CPU.with_(layout=mesh).key()
    assert CPU.with_(layout=mesh).key() == \
        CPU.with_(layout=LogicalMesh({"data": 8})).key()


def test_context_key_refuses_what_is_not_a_layout():
    """A layout is a FusionLayout, a mesh or None: anything else is
    refused when it would enter the context key, not keyed by identity."""
    with pytest.raises(TypeError, match="FusionLayout, a mesh or None"):
        CPU.with_(layout=object()).key()


# --------------------------------------------------------------------------
# execution under an abstract mesh: local, to the reference's numbers
# --------------------------------------------------------------------------

def test_hybrid_parity_l2svm():
    X = rng.normal(size=(512, 20)).astype(np.float32)
    y = np.sign(rng.normal(size=(512, 1))).astype(np.float32)
    w_ref, obj_ref = ref_l2svm.run(jnp.asarray(X), jnp.asarray(y),
                                   max_iter=4, layout=RefMesh({"data": 8}))
    w, obj = l2svm.run(X, y, max_iter=4, kernels="never", device="cpu",
                       layout=LogicalMesh({"data": 8}))
    np.testing.assert_allclose(obj, obj_ref, rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-5)


def test_hybrid_parity_mlogreg():
    m, n, k = 400, 12, 4
    X = rng.normal(size=(m, n)).astype(np.float32)
    Y = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=m)]
    B_ref, nll_ref = ref_mlogreg.run(jnp.asarray(X), jnp.asarray(Y),
                                     max_outer=3, max_inner=5,
                                     layout=RefMesh({"data": 8}))
    B, nll = mlogreg.run(X, Y, max_outer=3, max_inner=5, kernels="never",
                         device="cpu", layout=LogicalMesh({"data": 8}))
    np.testing.assert_allclose(nll, nll_ref, rtol=1e-5)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), rtol=1e-5,
                               atol=1e-5)


def test_hybrid_grad_parity():
    """The gradient through a hybrid plan (the planned backward under the
    same layout) equals the reference's."""
    m, n, k = 400, 12, 4
    X = rng.normal(size=(m, n)).astype(np.float32)
    B = (rng.normal(size=(n, k)) * 0.1).astype(np.float32)
    Y = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=m)]
    lam = np.full((1, 1), 1e-3, np.float32)
    with RefContext(mode="gen", layout=RefMesh({"data": 8})):
        g_ref = jax.grad(lambda B_: ref_mlogreg._nll_obj_reg(
            jnp.asarray(X), B_, jnp.asarray(Y), jnp.asarray(lam))[0, 0])(
            jnp.asarray(B))
    Bt = torch.tensor(B, requires_grad=True)
    with CPU.with_(layout=LogicalMesh({"data": 8})):
        val = mlogreg._nll_obj_reg(torch.tensor(X), Bt, torch.tensor(Y),
                                   torch.tensor(lam))[0, 0]
        (g,) = torch.autograd.grad(val, Bt)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# the panel CPlans of a distributed operator
# --------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def _dist_cplans(m: int, n: int = 100, k: int = 5, ranks: int = 4):
    """(CPlan, placement) of every distributed operator of the L2SVM and
    MLogReg regions (forward and planned backward) on a data-``ranks``
    mesh, planned on shapes alone."""
    from repro_torch.core.codegen import compile_plan
    X, col = _meta(m, n), _meta(m, 1)
    regions = [(l2svm._hinge, (X, _meta(n, 1), col)),
               (l2svm._search_terms, (col, col)),
               (l2svm._objective_full, (X, _meta(n, 1), col, _meta(1, 1))),
               (mlogreg._probs, (X, _meta(n, k))),
               (mlogreg._nll_obj_reg, (X, _meta(n, k), _meta(m, k),
                                       _meta(1, 1))),
               (mlogreg._hvp, (X, _meta(n, k), _meta(m, k)))]
    out = []
    with FusionContext(layout=LogicalMesh({"data": ranks})):
        for region, args in regions:
            planned = region.trace(*args).plan()
            for p in (planned, planned.backward()):
                cp = compile_plan(p.eplan)
                specs = [s for s in p.eplan.specs if getattr(
                    s, "placement", None) is not None]
                out += [(c, s.placement) for c, s in zip(cp.cplans(), specs)
                        if s.placement.arm == "distributed"]
    return out


@pytest.mark.parametrize("m", [10_000_000, 10_004])
def test_panel_cplans_generate_the_whole_operand_kernel_sources(m):
    """A rank's operator is the panel CPlan of its (whole-operand) CPlan:
    its sharded binds, the row-aligned program values and the output take
    the panel's rows, nothing else changes — and its CUDA source is the
    whole CPlan's, byte for byte, so one build (made before the ranks
    start) serves both.  10,004 rows give panels of 2,501, whose (m, 1)
    operands start off a 16-byte boundary."""
    from repro_torch.core.cplan import NO_AGG, ROW_AGG, panel_cplan
    from repro_torch.kernels import cuda_src
    cps = _dist_cplans(m)
    assert len(cps) >= 10
    for cp, pl in cps:
        rows = cp.main.shape[0] // pl.n
        panels = frozenset(b.nid for b in cp.binds if b.nid in pl.sharded)
        assert cp.main.nid in panels
        pcp = panel_cplan(cp, rows, panels)
        assert panel_cplan(cp, rows, panels) is pcp         # memoized
        for b, pb in zip(cp.binds, pcp.binds):
            assert pb.shape == ((rows, b.shape[1]) if b.nid in panels
                                else b.shape)
        for (_n, _o, _i, shape, _a), (_n2, _o2, _i2, pshape, _a2) in zip(
                cp.prog, pcp.prog):
            assert pshape in (shape, (rows, shape[1]))
        assert pcp.out_shape == ((rows, cp.out_shape[1]) if cp.variant in
                                 (NO_AGG, ROW_AGG) else cp.out_shape)
        assert cuda_src.source_for(pcp).text == \
            cuda_src.source_for(cp).text


def test_outer_panel_cplan_generates_the_whole_operand_source():
    """The distributed ALS ``right_mm`` over a rank's block rows of the
    Netflix-shaped BCSR (3,752 block rows, 938 a rank): its panel CPlan's
    Outer source is the whole CPlan's."""
    from repro_torch.algos import als_cg
    from repro_torch.core.codegen import compile_plan
    from repro_torch.core.cplan import panel_cplan
    from repro_torch.kernels import cuda_src
    from repro_torch.kernels.blocksparse import BCSR
    m, n, bs = 480_256, 17_792, 128
    nb = round(0.25 * (m // bs) * (n // bs))
    idx = torch.empty(nb, dtype=torch.int32, device="meta")
    X = BCSR(torch.empty((nb, bs, bs), device="meta"), idx, idx, (m, n), bs)
    with FusionContext(layout=LogicalMesh({"data": 4})):
        planned = als_cg._wsq_mm.trace(X, _meta(m, 20), _meta(n, 20)).plan()
    (spec,) = planned.eplan.fused_specs()
    pl = spec.placement
    assert (pl.arm, pl.epilogue) == ("distributed", "none")
    (cp,) = compile_plan(planned.eplan).cplans()
    pcp = panel_cplan(cp, m // 4, frozenset(pl.sharded))
    assert pcp.main.shape == (m // 4, n) and pcp.out_shape == (m // 4, 20)
    assert cuda_src.source_for(pcp, bs).text == \
        cuda_src.source_for(cp, bs).text


def test_segment_builders_fall_back_on_an_abstract_mesh():
    """``plan_segment`` and ``build_dist_fn`` validate against the mesh
    first: on a LogicalMesh each returns the abstract-mesh fallback (the
    reason ``explain()`` reports), as the reference's do."""
    from repro_torch.core.codegen import _segment_items, compile_plan
    from repro_torch.kernels.distributed import (SegmentFallback,
                                                 build_dist_fn, plan_segment)
    _ref_region, port_region, args = _cases()["segment_program"]
    mesh = LogicalMesh({"data": 8})
    with CPU:
        planned = port_region.trace(*args["pos"]).plan(layout=mesh)
    cp = compile_plan(planned.eplan)
    (seg,) = planned.eplan.segments
    items = _segment_items(planned.eplan.graph, planned.eplan, seg, cp.cache)
    fb = plan_segment(items, mesh)
    assert isinstance(fb, SegmentFallback) and "abstract mesh" in fb.reason
    built, fb = build_dist_fn(items[0].cplan, mesh, items[0].placement)
    assert built is None and "abstract mesh" in fb.reason
