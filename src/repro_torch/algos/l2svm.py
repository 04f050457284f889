"""L2-regularized squared-hinge SVM (2 classes) — SystemML `l2-svm.dml`.

Outer conjugate-direction iterations with an exact inner Newton line
search.  Fusion sites: the hinge chain relu(1 − y⊙(Xw)) (Row, the matmul
inside the program), the line-search multi-aggregate (MAgg), and the
objective (Row full_agg + single-root MAgg).

The gradient is ``torch.autograd.grad`` of the fused objective: the
backward pass is planned through explore → select, so ∇obj executes
generated fused operators too.
"""

from __future__ import annotations

import torch

from .util import fs, run_context
from repro_torch import spans
from repro_torch.core import ir, fused
from repro_torch.interop import to_torch

# fused regions ---------------------------------------------------------------

@fused
def _hinge(X, w, y):
    return ir.relu(1.0 - y * (X @ w))


@fused
def _objective_full(X, w, y, lam):
    """0.5·Σ relu(1 − y⊙(Xw))² + 0.5·λ·Σ w² — differentiable fused forward;
    its gradient replaces the hand-written −Xᵀ(out⊙y) + λw."""
    out = ir.relu(1.0 - y * (X @ w))
    return 0.5 * (out ** 2).sum() + 0.5 * lam * (w ** 2).sum()


# hand-derived gradient + split objective: golden-plan pins and the
# gradient parity checks — not used by run().
@fused
def _grad(X, out, y, w, lam):
    return -1.0 * (X.T @ (out * y)) + lam * w


@fused
def _search_terms(out, yXs):
    act = out > 0.0
    return (act * out * yXs).sum(), (act * yXs * yXs).sum()


@fused
def _objective(out, w):
    return (out ** 2).sum(), (w ** 2).sum()


@spans.spanned("l2svm.run")
def run(X, y, lam: float = 1e-3, max_iter: int = 20, eps: float = 1e-12,
        mode: str = "gen", kernels: str = "cuda", device=None,
        layout=None):
    """Returns (w, objective per iteration).

    ``X`` (m,n) and ``y`` (m,1) may be numpy arrays or tensors; they are
    moved to the context's device (``device``, by default the card).
    ``kernels="never"`` runs every fused operator through the torch-eager
    interpreter instead of the generated CUDA kernels.  ``layout`` (a
    mesh or ``FusionLayout``) plans every fused region hybrid
    local/distributed: the row-parallel operators over X run on the
    ranks' row panels of a :class:`~repro_torch.dist.Mesh` (all-reduce or
    all-gather epilogues), the small w-space aggregates stay local; each
    rank passes the whole X and y and runs on its mesh's device."""
    ctx = run_context(mode, kernels, device, layout)
    with spans.span("l2svm.init"):
        X, y = to_torch(X, ctx.device), to_torch(y, ctx.device)
    if mode == "hand":
        return _run_hand(X, y, lam, max_iter, eps)
    m, n = X.shape
    w = torch.zeros((n, 1), dtype=torch.float32, device=X.device)
    lam_s = torch.full((1, 1), lam, dtype=torch.float32, device=X.device)
    objs = []
    with ctx:
        def obj_grad(w_):
            w_ = w_.detach().requires_grad_(True)
            val = _objective_full(X, w_, y, lam_s)[0, 0]
            (g,) = torch.autograd.grad(val, w_)
            return val.detach(), g

        _, g = obj_grad(w)
        s = -g
        for _ in range(max_iter):
            Xs = X @ s                        # basic GEMV
            out = _hinge(X, w, y)
            num_t, den_t = _search_terms(out, y * Xs)
            num = fs(num_t) - lam * fs(torch.sum(w * s))
            den = fs(den_t) + lam * fs(torch.sum(s * s))
            step = num / max(den, 1e-30)
            w = w + step * s
            val, g_new = obj_grad(w)          # fused forward + fused backward
            objs.append(fs(val))
            beta = fs(torch.sum(g_new * g_new)) / max(
                fs(torch.sum(g * g)), 1e-30)
            s = -g_new + beta * s
            g = g_new
            if fs(torch.sum(g * g)) < eps:
                break
    return w, objs


def _run_hand(X, y, lam, max_iter, eps):
    """Hand-written torch baseline (the paper's 'Fused' arm)."""
    m, n = X.shape
    w = torch.zeros((n, 1), dtype=torch.float32, device=X.device)
    out = torch.clamp_min(1.0 - y * (X @ w), 0.0)
    g = -(X.T @ (out * y)) + lam * w
    s = -g
    objs = []
    for _ in range(max_iter):
        Xs = X @ s
        out = torch.clamp_min(1.0 - y * (X @ w), 0.0)
        act = (out > 0).to(torch.float32)
        yXs = y * Xs
        num = fs(torch.sum(act * out * yXs)) - lam * fs(torch.sum(w * s))
        den = fs(torch.sum(act * yXs * yXs)) + lam * fs(torch.sum(s * s))
        step = num / max(den, 1e-30)
        w = w + step * s
        out = torch.clamp_min(1.0 - y * (X @ w), 0.0)
        objs.append(0.5 * fs(torch.sum(out ** 2))
                    + 0.5 * lam * fs(torch.sum(w ** 2)))
        g_new = -(X.T @ (out * y)) + lam * w
        beta = fs(torch.sum(g_new * g_new)) / max(fs(torch.sum(g * g)),
                                                     1e-30)
        s = -g_new + beta * s
        g = g_new
        if fs(torch.sum(g * g)) < eps:
            break
    return w, objs
