"""The port's fused regions of the paper algorithms (``repro_torch.algos``),
with their operand shapes.  Imports no JAX, so the card-only tests can use
it too."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import torch

from repro_torch.algos import (als_cg, autoencoder, glm, kmeans, l2svm,
                               mlogreg)
from repro_torch.core import FusionContext


@functools.cache
def chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (its kernel check's
    limit and its planted fault)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def regions(m: int, n: int, k: int = 5) -> dict:
    """name -> (port Fused, {operand: shape}); the autoencoder's batch is
    X's shape, with n // 2 units in its outer hidden layers and 2 in the
    middle one."""
    X, w, col, lam = (m, n), (n, 1), (m, 1), (1, 1)
    B, P = (n, k), (m, k)
    h1, h2 = max(n // 2, 1), 2
    return {
        "l2svm/hinge": (l2svm._hinge, dict(X=X, w=w, y=col)),
        "l2svm/grad": (l2svm._grad, dict(X=X, out=col, y=col, w=w,
                                         lam=lam)),
        "l2svm/search_terms": (l2svm._search_terms, dict(out=col, yXs=col)),
        "l2svm/objective": (l2svm._objective, dict(out=col, w=w)),
        "l2svm/objective_full": (l2svm._objective_full,
                                 dict(X=X, w=w, y=col, lam=lam)),
        "mlogreg/probs": (mlogreg._probs, dict(X=X, B=B)),
        "mlogreg/nll_obj_reg": (mlogreg._nll_obj_reg,
                                dict(X=X, B=B, Y=P, lam=lam)),
        "mlogreg/hvp": (mlogreg._hvp, dict(X=X, v=B, P=P)),
        "mlogreg/grad": (mlogreg._grad, dict(X=X, P=P, Y=P)),
        "mlogreg/nll_terms": (mlogreg._nll_terms, dict(P=P, Y=P)),
        "mlogreg/fit_terms": (mlogreg._fit_terms, dict(X=X, B=B, Y=P)),
        "glm/link_chain": (glm._link_chain, dict(eta=col, y=col)),
        "glm/wxv": (glm._wxv, dict(X=X, w=col, v=w)),
        "glm/wz": (glm._wz, dict(X=X, w=col, r=col)),
        "glm/deviance": (glm._deviance, dict(y=col, eta=col)),
        "kmeans/sq_rowsums": (kmeans._sq_rowsums, dict(X=(m, 50))),
        "kmeans/min_dist": (kmeans._min_dist, dict(XC=(m, 5), xsq=col,
                                                   csq=(1, 5))),
        "autoencoder/recon_loss": (autoencoder._recon_loss, dict(
            Xb=X, W1=(n, h1), b1=(1, h1), W2=(h1, h2), b2=(1, h2),
            W3=(h2, h1), b3=(1, h1), W4=(h1, n), b4=(1, n))),
    }


#: ALS-CG's regions, planned over a BCSR X (m, n) with U (m, r), V (n, r)
ALS_REGIONS = {"als/wsq_mm": als_cg._wsq_mm,
               "als/loss_terms": als_cg._loss_terms}


def inputs(shapes: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded numpy operands (positive P-like operands stay positive so
    log() is defined)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        v = rng.normal(size=shape).astype(np.float32) * 0.5
        if name in ("P", "Y", "out"):
            v = np.abs(v) + 0.05
        out[name] = v
    return out


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


#: inputs whose gradient of the summed outputs the parity tests compare
GRADS = {
    "l2svm/hinge": ("X", "w", "y"),
    "l2svm/objective_full": ("X", "w", "lam"),
    "l2svm/grad": ("X", "out", "w", "lam"),
    "l2svm/search_terms": ("yXs",),
    "l2svm/objective": ("out", "w"),
    "mlogreg/nll_obj_reg": ("X", "B", "lam"),
    "mlogreg/probs": ("B",),
    "mlogreg/hvp": ("v",),
    "mlogreg/fit_terms": ("X", "B", "Y"),
    "glm/link_chain": ("eta", "y"),
    "glm/wxv": ("w", "v"),
    "glm/wz": ("X", "w", "r"),
    "glm/deviance": ("eta",),
    "autoencoder/recon_loss": ("Xb", "W1", "b1", "W2", "b2", "W3", "b3",
                               "W4", "b4"),
}


def run_port(region, vals: dict, grad_wrt=(), mode: str = "gen",
             kernels: str = "cuda", device: str = "cpu"):
    """(outputs, {name: grad}) of the port's Compiled on ``device``, as
    numpy arrays."""
    ctx = FusionContext(mode=mode, kernels=kernels, device=device)
    compiled = region.trace(**vals).plan(context=ctx).compile()
    args = {k: torch.tensor(v, device=device, requires_grad=k in grad_wrt)
            for k, v in vals.items()}
    outs = as_tuple(compiled(**args))
    grads = {}
    if grad_wrt:
        total = sum(o.sum() for o in outs)
        gs = torch.autograd.grad(total, [args[g] for g in grad_wrt])
        grads = {g: v.cpu().numpy() for g, v in zip(grad_wrt, gs)}
    return tuple(o.detach().cpu().numpy() for o in outs), grads
