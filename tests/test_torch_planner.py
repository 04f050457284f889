"""Planner parity: the port's copied planner selects exactly the reference's
plans — fused-operator signatures, rewrite winner and plan cost, forward
and planned backward — under the reference's TPU_V5E cost constants, on the
regions of L2SVM, mlogreg, GLM, kmeans and the autoencoder at paper
scale, and matches the pinned goldens in ``tests/golden/plans.json``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import fusion_mode as ref_fusion_mode
from repro_torch.core import FusionContext, TPU_V5E, fusion_mode
from repro_torch.core.select import MultiAggSpec
from repro_torch.hw import H100_SXM, TPU_V5E as HW_TPU_V5E

from torch_harness import ALS_REFERENCE, regions
from torch_regions import ALS_REGIONS

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "plans.json"
REGIONS = regions(10_000, 100)
#: the autoencoder at the paper configuration: batch 512 x 784, H1 500, H2 2
_H1, _H2, _N = 500, 2, 784
REGIONS["autoencoder/recon_loss@paper"] = REGIONS["autoencoder/recon_loss"][
    :2] + (dict(Xb=(512, _N), W1=(_N, _H1), b1=(1, _H1), W2=(_H1, _H2),
                b2=(1, _H2), W3=(_H2, _H1), b3=(1, _H1), W4=(_H1, _N),
                b4=(1, _N)),)
#: regions whose backward the pipeline plans (differentiable fused forward)
BACKWARD = ("l2svm/objective_full", "mlogreg/nll_obj_reg", "l2svm/hinge",
            "autoencoder/recon_loss", "autoencoder/recon_loss@paper",
            "glm/link_chain", "glm/wxv", "glm/wz", "glm/deviance")


def _zeros(shapes):
    return {k: np.zeros(s, np.float32) for k, s in shapes.items()}


def _golden_signature(eplan):
    """tests/test_golden_plans.py's signature, over the port's ExecPlan."""
    g = eplan.graph
    label = lambda nid: g.by_id[nid].name or g.by_id[nid].op
    sigs = []
    for s in eplan.fused_specs():
        if isinstance(s, MultiAggSpec):
            sigs.append({"template": "MAGG(multi)",
                         "root": [g.by_id[r].op for r in s.roots],
                         "inputs": sorted(label(i) for i in s.inputs),
                         "driver": None})
        else:
            sigs.append({"template": s.ttype.name,
                         "root": g.by_id[s.root].op,
                         "inputs": sorted(label(i) for i in s.inputs),
                         "driver": (label(s.driver)
                                    if s.driver is not None else None),
                         "n_covered": len(s.cover)})
    return sorted(sigs, key=lambda d: json.dumps(d, sort_keys=True))


def _plans(name):
    ref, port, shapes = REGIONS[name]
    vals = _zeros(shapes)
    with ref_fusion_mode("gen"):
        rp = ref.trace(**vals).plan()
    pp = port.trace(**vals).plan(context=FusionContext(device="cpu"))
    return rp, pp


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_signatures_rewrite_and_cost_match_reference(name):
    rp, pp = _plans(name)
    assert pp.fused_signatures() == rp.fused_signatures()
    assert pp.cost == pytest.approx(rp.cost, rel=1e-12)
    assert pp.explain()["rewrite"]["winner"] == \
        rp.explain()["rewrite"]["winner"]
    assert [type(s).__name__ for s in pp.eplan.specs] == \
        [type(s).__name__ for s in rp.eplan.specs]


@pytest.mark.parametrize("name", BACKWARD)
def test_planned_backward_matches_reference(name):
    rp, pp = _plans(name)
    rb, pb = rp.backward(), pp.backward()
    assert pb.fused_signatures() == rb.fused_signatures()
    assert pb.cost == pytest.approx(rb.cost, rel=1e-12)
    assert pb.grad_names == rb.grad_names


def test_golden_plans_match():
    golden = json.loads(GOLDEN.read_text())
    assert set(golden) <= set(REGIONS)
    with fusion_mode("gen", device="cpu"):
        for name in golden:
            _ref, port, shapes = REGIONS[name]
            got = _golden_signature(port.plan_for(**_zeros(shapes)))
            assert got == golden[name], name


def test_planning_default_is_the_reference_tpu_constants():
    """The port plans under the reference's TPU constants (plan parity);
    the H100 datasheet figures sit beside them, unused by the planner."""
    assert FusionContext().params is TPU_V5E
    assert TPU_V5E.read_bw == HW_TPU_V5E.hbm_bw
    assert H100_SXM.hbm_bw == 3.35e12 and H100_SXM.peak_flops == 989e12
    assert H100_SXM.hbm_bytes == 80e9


@pytest.mark.parametrize("n", [1, 8])
def test_layout_is_accepted_and_plans_as_the_reference(n):
    """``plan(layout=)`` and a context layout are accepted: under an
    abstract mesh the hinge region plans the reference's operators, costs
    and placements, and the layout enters the context key."""
    from repro.dist.planner import LogicalMesh as RefMesh
    from repro_torch.dist import LogicalMesh
    ref, port, shapes = REGIONS["l2svm/hinge"]
    want = ref.trace(**_zeros(shapes)).plan(mode="gen",
                                            layout=RefMesh({"data": n}))
    with fusion_mode(device="cpu"):
        got = port.trace(**_zeros(shapes)).plan(
            mode="gen", layout=LogicalMesh({"data": n}))
    assert got.cost == want.cost
    assert got.fused_signatures() == want.fused_signatures()
    assert FusionContext(layout=LogicalMesh({"data": n})).key() != \
        FusionContext().key()


def _bcsr_pair(shape, bs, nb):
    """A reference and a port BCSR of ``shape`` with ``nb`` blocks and no
    data (planning reads shapes and block sparsity only)."""
    import jax
    from repro.kernels.blocksparse import BCSR as RBCSR
    from repro_torch.kernels.blocksparse import BCSR
    idx = lambda: jax.ShapeDtypeStruct((nb,), np.int32)
    ref = RBCSR(jax.ShapeDtypeStruct((nb, bs, bs), np.float32), idx(), idx(),
                shape, bs)
    meta = torch.empty(nb, dtype=torch.int32, device="meta")
    port = BCSR(torch.empty((nb, bs, bs), device="meta"), meta, meta, shape,
                bs)
    return ref, port


#: ALS-CG at the paper's Netflix shape (480,189 x 17,770 padded to bs 128,
#: block density 0.25) and its transpose (the V update), and a small grid
ALS_SHAPES = {"netflix": ((480_256, 17_792), 130_382),
              "netflix_t": ((17_792, 480_256), 130_382),
              "small": ((384, 256), 4)}


@pytest.mark.parametrize("shape_name", sorted(ALS_SHAPES))
@pytest.mark.parametrize("name", sorted(ALS_REGIONS))
def test_als_regions_plan_as_the_reference_over_bcsr(name, shape_name):
    """Same fused-operator signatures, cost, template, variant and
    ``main.exploit`` as the reference, with X a BCSR."""
    from repro.core.cplan import build_cplan as ref_build_cplan
    from repro_torch.core.codegen import compile_plan
    (m, n), nb = ALS_SHAPES[shape_name]
    xr, xt = _bcsr_pair((m, n), 128, nb)
    U, V = np.zeros((m, 20), np.float32), np.zeros((n, 20), np.float32)
    with ref_fusion_mode("gen"):
        rp = ALS_REFERENCE[name].trace(xr, U, V).plan()
    pp = ALS_REGIONS[name].trace(xt, U, V).plan(
        context=FusionContext(device="cpu"))
    assert pp.explain()["inputs"]["X"]["format"] == "bcsr"
    assert pp.explain()["inputs"]["X"]["sparsity"] == \
        rp.explain()["inputs"]["X"]["sparsity"]
    assert pp.fused_signatures() == rp.fused_signatures()
    assert pp.cost == pytest.approx(rp.cost, rel=1e-12)
    rcps = [ref_build_cplan(rp.eplan.graph, s)
            for s in rp.eplan.fused_specs()]
    pcps = compile_plan(pp.eplan).cplans()
    assert [(c.ttype.name, c.variant, c.main.exploit) for c in pcps] == \
        [(c.ttype.name, c.variant, c.main.exploit) for c in rcps]
    assert [c.cache_key() for c in pcps] == [c.cache_key() for c in rcps]
    assert pcps[0].ttype.name == "OUTER" and pcps[0].main.exploit
