"""Multinomial logistic regression via trust-region Newton-CG — SystemML
`MultiLogReg.dml`.

The Hessian-vector product is the paper's Expression (2):

    Q = P[,1:k] ⊙ (X v)
    H = Xᵀ (Q − P[,1:k] ⊙ rowSums(Q))     — one Row-template pass over X.

Fusion sites: softmax probabilities (Row), the HVP (Row col_t_agg), the
gradient (the planned backward of the regularized objective: Row passes
over X plus the B-space Cell chain), and the log-likelihood aggregate.
"""

from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.core import ir, fused
from .util import fs, run_context
from repro_torch.interop import to_torch


def _softmax_probs_expr(X, B):
    """P (m,k) from logits X@B — full k-class softmax (Icpt=0, paper
    config)."""
    Z = X @ B
    m = Z.rowmaxs()
    E = ir.exp(Z - m)
    return E / E.rowsums()


_probs = fused(_softmax_probs_expr)


@fused
def _nll_obj_reg(X, B, Y, lam):
    """−Σ Y⊙log P + 0.5·λ·Σ B² — the full regularized objective as one
    fused region: the X-row-parallel softmax/NLL chain and the tiny B-space
    regularizer multi-aggregate.  ``run`` differentiates it."""
    Z = X @ B
    m = Z.rowmaxs()
    E = ir.exp(Z - m)
    P = E / E.rowsums()
    return (0.0 - (Y * ir.log(P + 1e-30)).sum()
            + 0.5 * lam * (B ** 2).sum())


@fused
def _hvp(X, v, P):
    Q = P * (X @ v)
    return X.T @ (Q - P * Q.rowsums())


# hand-derived gradient + NLL aggregate: golden-plan pins and the gradient
# parity checks — run() differentiates the regularized _nll_obj_reg.
@fused
def _grad(X, P, Y):
    return X.T @ (P - Y)


@fused
def _nll_terms(P, Y):
    return (Y * ir.log(P + 1e-30)).sum()


# the fit sufficient statistic ⟨XᵀY, B⟩ = Σ B⊙(XᵀY), written in its
# textbook form; the rewrite sweep rotates it into sum((X@B)⊙Y), a single
# Row pass over X with no (n,k) intermediate.
@fused
def _fit_terms(X, B, Y):
    return (B * (X.T @ Y)).sum()


@spans.spanned("mlogreg.run")
def run(X, Y, lam: float = 1e-3, max_outer: int = 10, max_inner: int = 20,
        eps: float = 1e-12, mode: str = "gen", kernels: str = "cuda",
        device=None, layout=None):
    """Returns (B, regularized objective per outer iteration).

    ``X`` (m,n) and one-hot ``Y`` (m,k) may be numpy arrays or tensors;
    they move to the context's device (``device``, by default the card).
    ``kernels="never"`` runs every fused operator through the torch-eager
    interpreter instead of the generated CUDA kernels.  ``layout`` (a
    mesh or ``FusionLayout``) plans every fused region hybrid
    local/distributed — see :func:`repro_torch.algos.l2svm.run`."""
    ctx = run_context(mode, kernels, device, layout)
    with spans.span("mlogreg.init"):
        X, Y = to_torch(X, ctx.device), to_torch(Y, ctx.device)
    if mode == "hand":
        return _run_hand(X, Y, lam, max_outer, max_inner, eps)
    m, n = X.shape
    k = Y.shape[1]
    B = torch.zeros((n, k), dtype=torch.float32, device=X.device)
    lam_s = torch.full((1, 1), lam, dtype=torch.float32, device=X.device)
    nlls = []
    with ctx:
        def obj_grad(B_):
            B_ = B_.detach().requires_grad_(True)
            val = _nll_obj_reg(X, B_, Y, lam_s)[0, 0]
            (G,) = torch.autograd.grad(val, B_)
            return val.detach(), G

        for _ in range(max_outer):
            P = _probs(X, B)
            val, G = obj_grad(B)          # fused forward + fused backward
            nlls.append(fs(val))
            # CG solve (H + lam I) d = -G with fused HVPs
            d = torch.zeros_like(B)
            r = -G
            p = r
            rs = fs(torch.sum(r * r))
            for _ in range(max_inner):
                Hp = _hvp(X, p, P) + lam * p
                alpha = rs / max(fs(torch.sum(p * Hp)), 1e-30)
                d = d + alpha * p
                r = r - alpha * Hp
                rs_new = fs(torch.sum(r * r))
                if rs_new < eps:
                    break
                p = r + (rs_new / rs) * p
                rs = rs_new
            B = B + d
    return B, nlls


def _run_hand(X, Y, lam, max_outer, max_inner, eps):
    """Hand-written torch baseline (the paper's 'Fused' arm)."""
    m, n = X.shape
    k = Y.shape[1]
    B = torch.zeros((n, k), dtype=torch.float32, device=X.device)
    nlls = []

    def probs(B):
        Z = X @ B
        Z = Z - Z.max(dim=1, keepdim=True).values
        E = torch.exp(Z)
        return E / E.sum(dim=1, keepdim=True)

    for _ in range(max_outer):
        P = probs(B)
        nll = -fs(torch.sum(Y * torch.log(P + 1e-30))) \
            + 0.5 * lam * fs(torch.sum(B * B))
        nlls.append(nll)
        G = X.T @ (P - Y) + lam * B
        d = torch.zeros_like(B)
        r = -G
        p = r
        rs = fs(torch.sum(r * r))
        for _ in range(max_inner):
            Q = P * (X @ p)
            Hp = X.T @ (Q - P * Q.sum(dim=1, keepdim=True)) + lam * p
            alpha = rs / max(fs(torch.sum(p * Hp)), 1e-30)
            d = d + alpha * p
            r = r - alpha * Hp
            rs_new = fs(torch.sum(r * r))
            if rs_new < eps:
                break
            p = r + (rs_new / rs) * p
            rs = rs_new
        B = B + d
    return B, nlls
