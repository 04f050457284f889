"""``repro_torch.core.fuse_exprs`` against the reference's ``fuse_exprs``,
and ``FusionLayout.apply``'s identity cases, on the CPU.

Each region is a hand-built expression DAG (``ir.matrix`` leaves) built
once in each package on the same numpy inputs from a seed; the reference
runs as its own CPU tests run it (``pallas="never"``, its plain jnp
lowering).  Outputs are held to the reference's at 1e-5:

* dense regions — L2SVM's hinge, its search terms and objective, Σw², the
  MLogReg softmax and a Cell/column-aggregate chain — under modes gen, fa
  and fnr, with single and tuple outputs;
* ALS's ``_wsq_mm`` with a BCSR binding;
* the reference's segment program scoped under ``LogicalMesh({"data":
  8})``, whose fused operators' signatures (placement, epilogue and
  collective bytes included) equal the reference's.

The port's ``fuse_exprs`` runs the same whole-plan-cached function as the
``@fused`` staged path on L2SVM's regions (equal staged keys), so the two
agree bit for bit; the card's check of that is ``chip_smoke.py``'s.
"""

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import api as ref_api
from repro.core import ir as ref_ir
from repro.dist.planner import LogicalMesh as RefMesh
from repro.kernels.blocksparse import BCSR as RefBCSR
from repro_torch.algos import l2svm
from repro_torch.core import FusionContext, FusionLayout, fuse_exprs, fused
from repro_torch.core import api
from repro_torch.core import ir
from repro_torch.dist import LogicalMesh, Mesh
from repro_torch.kernels.blocksparse import BCSR, DictCompressed

import torch_dist_worker as worker

TOL = 1e-5
M, N, K = 96, 12, 4


def _hinge(ir, X, w, y):
    return ir.relu(1.0 - y * (X @ w))


def _search_terms(ir, out, yXs):
    act = out > 0.0
    return (act * out * yXs).sum(), (act * yXs * yXs).sum()


def _objective(ir, X, w, y, lam):
    out = ir.relu(1.0 - y * (X @ w))
    return 0.5 * (out ** 2).sum() + 0.5 * lam * (w ** 2).sum()


def _sum_sq(ir, w):
    return (w ** 2).sum()


def _probs(ir, X, B):
    E = ir.exp(X @ B)
    return E / E.rowsums()


def _cell_cols(ir, X, Y, v):
    A = ir.sigmoid(X * Y + v)
    return A.colsums(), (A - X).rowmaxs()


#: name -> (expression function, operand shapes)
REGIONS = {
    "hinge": (_hinge, {"X": (M, N), "w": (N, 1), "y": (M, 1)}),
    "search_terms": (_search_terms, {"out": (M, 1), "yXs": (M, 1)}),
    "objective": (_objective, {"X": (M, N), "w": (N, 1), "y": (M, 1),
                               "lam": (1, 1)}),
    "sum_sq": (_sum_sq, {"w": (N, 1)}),
    "probs": (_probs, {"X": (M, N), "B": (N, K)}),
    "cell_cols": (_cell_cols, {"X": (M, N), "Y": (M, N), "v": (1, N)}),
}


def _values(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {n: (0.3 * rng.standard_normal(s)).astype(np.float32)
           for n, s in shapes.items()}
    if "y" in out:
        out["y"] = np.sign(out["y"]) + (out["y"] == 0)
    if "lam" in out:
        out["lam"] = np.full((1, 1), 1e-3, np.float32)
    return out


def _exprs(irmod, build, shapes: dict, sparsity: dict | None = None):
    leaves = {n: irmod.matrix(n, s, sparsity=(sparsity or {}).get(n, 1.0))
              for n, s in shapes.items()}
    return build(irmod, **leaves)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _close(got, want) -> None:
    got, want = _as_tuple(got), _as_tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["gen", "fa", "fnr"])
@pytest.mark.parametrize("name", sorted(REGIONS))
def test_dense_region_matches_reference(name, mode):
    build, shapes = REGIONS[name]
    vals = _values(shapes, seed=sum(map(ord, name)))
    want = ref_core.fuse_exprs(_exprs(ref_ir, build, shapes), vals,
                               mode=mode)
    with FusionContext(device="cpu"):
        got = fuse_exprs(_exprs(ir, build, shapes), vals, mode=mode)
    _close(got, want)


def test_tensor_bindings_and_the_context_mode():
    """Tensor bindings are taken as they are; without ``mode`` the scoped
    context's mode plans."""
    build, shapes = REGIONS["probs"]
    vals = _values(shapes, seed=3)
    want = ref_core.fuse_exprs(_exprs(ref_ir, build, shapes), vals,
                               mode="fa")
    with FusionContext(mode="fa", device="cpu"):
        got = fuse_exprs(_exprs(ir, build, shapes),
                         {n: torch.tensor(v) for n, v in vals.items()})
    _close(got, want)


def test_fusion_mode_staged_false_dispatches_per_operator(monkeypatch):
    """``fusion_mode(staged=False)``, as the reference's, scopes the
    per-operator path; the values are the reference's."""
    from repro_torch.core import fusion_mode
    build, shapes = REGIONS["objective"]
    vals = _values(shapes, seed=4)
    cps = []
    real = api.compile_plan

    def spy(eplan, *args, **kw):
        cps.append(real(eplan, *args, **kw))
        return cps[-1]
    monkeypatch.setattr(api, "compile_plan", spy)
    with ref_core.fusion_mode(staged=False):
        want = ref_core.fuse_exprs(_exprs(ref_ir, build, shapes), vals)
    with fusion_mode(device="cpu", staged=False):
        got = fuse_exprs(_exprs(ir, build, shapes), vals)
    assert [cp.staged for cp in cps] == [False]
    _close(got, want)


def test_bcsr_binding_matches_reference():
    dense, U, V = worker._bcsr_dense(512, 256, 32, seed=7, density=0.1)
    shapes = {"X": dense.shape, "U": U.shape, "V": V.shape}
    Xp, Xr = BCSR.from_dense(dense, bs=32), RefBCSR.from_dense(dense, bs=32)
    sp = {"X": Xp.block_sparsity}
    expr = worker.outer_expr

    def build(irmod, X, U, V):
        return expr(irmod)(X, U, V)
    want = ref_core.fuse_exprs(_exprs(ref_ir, build, shapes, sp),
                               {"X": Xr, "U": U, "V": V})
    with FusionContext(device="cpu"):
        got = fuse_exprs(_exprs(ir, build, shapes, sp),
                         {"X": Xp, "U": U, "V": V})
    _close(got, want)


def _plan_signatures(module, monkeypatch) -> list:
    """Patch ``module.compile_plan`` to record the plan ``fuse_exprs``
    compiles; returns the list the signatures are appended to."""
    seen = []
    real = module.compile_plan

    def spy(eplan, *args, **kw):
        sigs = []
        for s in eplan.fused_specs():
            sig = module._spec_signature(eplan.graph, s)
            pl = getattr(s, "placement", None)
            if pl is not None:
                sig.update(placement=pl.arm, epilogue=pl.epilogue,
                           collective_bytes=int(round(pl.collective_bytes)))
            sigs.append(sig)
        seen.append(sigs)
        return real(eplan, *args, **kw)
    monkeypatch.setattr(module, "compile_plan", spy)
    return seen


def test_logical_mesh_scope_matches_reference_plan_and_values(monkeypatch):
    seg = worker.inputs()["seg"]
    names = ["X1", "X2", "X3", "X4", "X5", "X6", "w"]
    shapes = {n: v.shape for n, v in zip(names, seg)}
    vals = dict(zip(names, seg))

    def build(irmod, **xs):
        return worker.segment_expr(irmod)(**xs)
    ref_sigs = _plan_signatures(ref_api, monkeypatch)
    port_sigs = _plan_signatures(api, monkeypatch)
    with ref_core.FusionContext(layout=RefMesh({"data": 8})):
        want = ref_core.fuse_exprs(_exprs(ref_ir, build, shapes), vals)
    with FusionContext(device="cpu", layout=LogicalMesh({"data": 8})):
        got = fuse_exprs(_exprs(ir, build, shapes), vals)
    _close(got, want)
    assert len(port_sigs) == len(ref_sigs) == 1
    assert port_sigs[0] == ref_sigs[0]
    assert any(s.get("placement") == "distributed" for s in port_sigs[0])


@pytest.mark.parametrize("region", [l2svm._hinge, l2svm._search_terms,
                                    l2svm._objective_full])
def test_fuse_exprs_shares_the_fused_staged_function(region, monkeypatch):
    """On L2SVM's regions ``fuse_exprs`` compiles the plan the ``@fused``
    staged path runs: the same whole-plan key, the same numbers."""
    shapes = {"X": (M, N), "w": (N, 1), "y": (M, 1), "lam": (1, 1),
              "out": (M, 1), "yXs": (M, 1)}
    names = region.names
    shapes = {n: shapes[n] for n in names}
    vals = _values(shapes, seed=5)
    cps = []
    real = api.compile_plan

    def spy(eplan, *args, **kw):
        cps.append(real(eplan, *args, **kw))
        return cps[-1]
    monkeypatch.setattr(api, "compile_plan", spy)
    with FusionContext(device="cpu"):
        got = fuse_exprs(_exprs(ir, lambda _ir, **xs: region.fn(**xs),
                                shapes), vals)
        compiled = region.trace(**vals).plan().compile()
        want = compiled(**vals)
    assert cps[0]._staged_key == compiled._cplan._staged_key
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        assert torch.equal(g, w)


def test_bcsr_region_shares_the_fused_staged_function(monkeypatch):
    """ALS's ``_wsq_mm`` with a BCSR binding: the same whole-plan key as
    the ``@fused`` path, the same numbers."""
    from repro_torch.algos import als_cg
    dense, U, V = worker._bcsr_dense(512, 256, 32, seed=3, density=0.1)
    X = BCSR.from_dense(dense, bs=32)
    shapes = {"X": X.shape, "U": U.shape, "V": V.shape}
    cps = []
    real = api.compile_plan

    def spy(eplan, *args, **kw):
        cps.append(real(eplan, *args, **kw))
        return cps[-1]
    monkeypatch.setattr(api, "compile_plan", spy)
    with FusionContext(device="cpu"):
        got = fuse_exprs(_exprs(ir, lambda _ir, **xs: als_cg._wsq_mm.fn(**xs),
                                shapes, {"X": X.block_sparsity}),
                         {"X": X, "U": U, "V": V})
        compiled = als_cg._wsq_mm.trace(X, U, V).plan().compile()
        want = compiled(X, U, V)
    assert cps[0]._staged_key == compiled._cplan._staged_key
    assert torch.equal(got, want)


def test_sum_sq_shares_the_fused_staged_function():
    vals = _values({"w": (N, 1)}, seed=9)
    with FusionContext(device="cpu"):
        got = fuse_exprs(_exprs(ir, _sum_sq, {"w": (N, 1)}), vals)
        want = fused(lambda w: (w ** 2).sum())(vals["w"])
    assert torch.equal(got, want)


def test_default_context_asks_for_the_card():
    """No fallback to the CPU: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    build, shapes = REGIONS["sum_sq"]
    with pytest.raises(RuntimeError, match="cuda"):
        fuse_exprs(_exprs(ir, build, shapes), _values(shapes, seed=1))


def _mesh_stand_in(device: str = "cpu") -> Mesh:
    """A ``Mesh`` without a process group: ``apply`` reads only its type
    and device (the real one runs in ``tests/torch_dist_worker.py``)."""
    mesh = Mesh.__new__(Mesh)
    mesh.shape, mesh.axis_names = {"data": 2}, ("data",)
    mesh.device = torch.device(device)
    return mesh


def test_apply_is_the_identity_where_the_reference_is():
    x = np.ones((8, 4), np.float32)
    specs = {"X": ("data", None)}
    # abstract mesh: cost-only layout
    assert FusionLayout(LogicalMesh({"data": 2}), specs).apply("X", x) is x
    real = FusionLayout(_mesh_stand_in(), specs)
    # no spec for the name
    assert real.apply("Y", x) is x
    # sparse values
    Xs = BCSR.from_dense(x, bs=4)
    assert real.apply("X", Xs) is Xs
    Xd = DictCompressed.from_dense(x)
    assert real.apply("X", Xd) is Xd


def test_apply_places_the_whole_operand_on_the_mesh_device():
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    lay = FusionLayout(_mesh_stand_in(), {"X": ("data", None)})
    got = lay.apply("X", x)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == x.shape and np.array_equal(got.numpy(), x)
    t = torch.tensor(x)
    assert lay.apply("X", t) is t


def test_mesh_on_another_device_raises():
    lay = FusionLayout(_mesh_stand_in("meta"), {})
    build, shapes = REGIONS["sum_sq"]
    with FusionContext(device="cpu", layout=lay):
        with pytest.raises(ValueError, match="mesh's device"):
            fuse_exprs(_exprs(ir, build, shapes), _values(shapes, seed=1))
