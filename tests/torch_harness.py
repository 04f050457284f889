"""Two-package parity harness: the JAX reference (``repro``) and the
PyTorch port (``repro_torch``) on the same numpy inputs.

Modelled on ``tests/diffharness.py``: both sides go through the full
staged pipeline (``trace → plan → compile → run``) and must agree on every
forward output and on the gradient of the summed outputs with respect to
the requested inputs (``jax.grad`` against ``torch.autograd.grad``).

The region table pairs each reference ``Fused`` region with the port's
region of the same expression (``tests/torch_regions.py``), and
:func:`reference_cplan` plans a kernel-sweep case
(``repro_torch.kernels.sweep``) with the reference's planner.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.algos import als_cg as ref_als_cg
from repro.algos import autoencoder as ref_autoencoder
from repro.algos import glm as ref_glm
from repro.algos import kmeans as ref_kmeans
from repro.algos import l2svm as ref_l2svm
from repro.algos import mlogreg as ref_mlogreg
from repro.core import cost, cplan, explore, ir, select, templates
from repro.core.context import FusionContext as RefContext

import torch_regions as port
from torch_regions import as_tuple

DEFAULT_TOL = 1e-5


REFERENCE = {
    "l2svm/hinge": ref_l2svm._hinge,
    "l2svm/grad": ref_l2svm._grad,
    "l2svm/search_terms": ref_l2svm._search_terms,
    "l2svm/objective": ref_l2svm._objective,
    "l2svm/objective_full": ref_l2svm._objective_full,
    "mlogreg/probs": ref_mlogreg._probs,
    "mlogreg/nll_obj_reg": ref_mlogreg._nll_obj_reg,
    "mlogreg/hvp": ref_mlogreg._hvp,
    "mlogreg/grad": ref_mlogreg._grad,
    "mlogreg/nll_terms": ref_mlogreg._nll_terms,
    "mlogreg/fit_terms": ref_mlogreg._fit_terms,
    "glm/link_chain": ref_glm._link_chain,
    "glm/wxv": ref_glm._wxv,
    "glm/wz": ref_glm._wz,
    "glm/deviance": ref_glm._deviance,
    "kmeans/sq_rowsums": ref_kmeans._sq_rowsums,
    "kmeans/min_dist": ref_kmeans._min_dist,
    "autoencoder/recon_loss": ref_autoencoder._recon_loss,
}


ALS_REFERENCE = {"als/wsq_mm": ref_als_cg._wsq_mm,
                 "als/loss_terms": ref_als_cg._loss_terms}


def regions(m: int, n: int, k: int = 5) -> dict:
    """name -> (reference Fused, port Fused, {operand: shape})."""
    return {name: (REFERENCE[name], fn, shapes)
            for name, (fn, shapes) in port.regions(m, n, k).items()}


def reference_cplan(case, m: int, n: int, sparsity=None):
    """The reference's counterpart of ``repro_torch.kernels.sweep.
    fused_cplan``: ``case`` planned at (m, n) with the JAX package's
    planner; returns (cplan, {bind nid: operand name})."""
    sparsity = sparsity or {}
    exprs = {k: ir.matrix(k, s, sparsity=sparsity.get(k, 1.0))
             for k, s in case.shapes(m, n).items()}
    outs = case.expr(ir, **exprs)
    g = ir.Graph.build(list(outs) if isinstance(outs, tuple) else [outs])
    if case.want is not None:
        memo = explore.explore(g)
        root = g.outputs[0]
        want = templates.TType[case.want]
        entry = next(e for e in memo.entries(root.nid)
                     if e.ttype == want and e.can_root)
        spec = cost._build_spec(g, memo, root.nid, entry, set())
    else:
        p = select.plan(g, "gen")
        spec = [s for s in p.specs if getattr(s, "fused", False)][-1]
    cp = cplan.build_cplan(g, spec)
    names = {node.nid: node.name for node in g.inputs()}
    return cp, {b.nid: names[b.nid] for b in cp.binds}


# --------------------------------------------------------------------------
# execution on both packages
# --------------------------------------------------------------------------

def run_reference(region, vals: dict, grad_wrt=(), mode: str = "gen"):
    """(outputs, {name: grad}) of the JAX reference's Compiled."""
    with RefContext(mode=mode):
        compiled = region.trace(**vals).plan().compile()
    args = {k: jnp.asarray(v) for k, v in vals.items()}
    outs = tuple(np.asarray(o) for o in as_tuple(compiled(**args)))
    grads = {}
    for g in grad_wrt:
        def total(v, g=g):
            b = dict(args)
            b[g] = v
            return sum(jnp.sum(o) for o in as_tuple(compiled(**b)))
        grads[g] = np.asarray(jax.grad(total)(args[g]))
    return outs, grads


def allclose(got, want, tol: float = DEFAULT_TOL, label: str = "") -> None:
    got, want = as_tuple(got), as_tuple(want)
    assert len(got) == len(want), f"{label}: arity {len(got)} != {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=f"{label}[out {i}]")
