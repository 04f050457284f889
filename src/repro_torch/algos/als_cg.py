"""ALS-CG matrix factorization (rank 20, weighted-L2) — SystemML `ALS-CG.dml`.

The paper's flagship sparsity workload.  Each factor update runs conjugate
gradient where gradient and Hessian-action are Outer-template operators
over the block-sparse ratings:

    grad_U = ((X≠0) ⊙ (UVᵀ))·V − X·V + λU          (Expression (1))
    H_U(s) = ((X≠0) ⊙ (sVᵀ))·V + λs

Work is ∝ non-zero blocks of X — never the dense m×n product.  The V
update runs the same operators against Xᵀ (BCSR transpose).  On the card,
``_wsq_mm`` (Outer ``right_mm``) and ``_loss_terms`` (Outer ``full_agg``)
run the Outer CUDA kernel; ``X·V`` is the block-sparse basic product.
"""

from __future__ import annotations

import numpy as np
import torch

from .util import fs
from repro_torch import spans
from repro_torch.core import ir, fused, FusionContext
from repro_torch.interop import resolve_device, to_bcsr, to_torch
from repro_torch.kernels.blocksparse import BCSR
from repro_torch.kernels.ops import bcsr_matmul


@fused
def _wsq_mm(X, U, V):
    """((X≠0) ⊙ (U Vᵀ)) V — the sparsity-exploiting right_mm."""
    return (ir.neq0(X) * (U @ V.T)) @ V


@fused
def _loss_terms(X, U, V):
    """Σ ((X≠0)⊙(UVᵀ − X))² — sparse-safe squared error over non-zeros.

    (X≠0)⊙X = X, so the residual chain stays sparse-safe w.r.t. X."""
    R = ir.neq0(X) * (U @ V.T) - X
    return (R ** 2).sum()


def _grad_U(X, U, V, lam):
    return _wsq_mm(X, U, V) - bcsr_matmul(X, V) + lam * U


def _hvp_U(X, s, V, lam):
    return _wsq_mm(X, s, V) + lam * s


def _cg(U, grad, hvp, max_inner, eps):
    """``max_inner`` conjugate-gradient steps on the quadratic model
    (gradient ``grad`` at U, Hessian action ``hvp``); returns U + d."""
    g = grad(U)
    d = torch.zeros_like(U)
    r = -g
    p = r
    rs = fs(torch.sum(r * r))
    for _ in range(max_inner):
        Hp = hvp(p)
        alpha = rs / max(fs(torch.sum(p * Hp)), 1e-30)
        d = d + alpha * p
        r = r - alpha * Hp
        rs_new = fs(torch.sum(r * r))
        if rs_new < eps:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    return U + d


def _cg_update(X, U, V, lam, max_inner, eps):
    return _cg(U, lambda U_: _grad_U(X, U_, V, lam),
               lambda p: _hvp_U(X, p, V, lam), max_inner, eps)


def _init(m: int, n: int, rank: int, seed: int, device):
    """The reference's starting factors: the same numpy draws."""
    rng = np.random.default_rng(seed)
    U = to_torch(rng.normal(size=(m, rank)).astype(np.float32), device) * 0.1
    V = to_torch(rng.normal(size=(n, rank)).astype(np.float32), device) * 0.1
    return U, V


@spans.spanned("als_cg.run")
def run(X, rank: int = 20, lam: float = 1e-3, max_iter: int = 6,
        max_inner: int = 5, eps: float = 1e-12, mode: str = "gen",
        kernels: str = "cuda", device=None, seed: int = 0):
    """Returns (U, V, loss per outer iteration).

    ``X`` is a :class:`BCSR` (or anything :func:`repro_torch.interop.
    to_bcsr` takes); it moves to the context's device (``device``, by
    default the card).  ``kernels="never"`` runs every fused operator
    through the torch block loop instead of the Outer kernel;
    ``mode="hand"`` is the dense-mask torch baseline."""
    ctx = FusionContext(mode="gen" if mode == "hand" else mode,
                        kernels=kernels)
    if device is not None:
        ctx = ctx.with_(device=device)
    X = to_bcsr(X, resolve_device(ctx.device))
    if mode == "hand":
        return _run_hand(X, rank, lam, max_iter, max_inner, eps, seed)
    m, n = X.shape
    with spans.span("als_cg.init"):
        U, V = _init(m, n, rank, seed, X.device)
        with spans.span("als_cg.transpose"):
            XT = X.T
    losses = []
    with ctx:
        for _ in range(max_iter):
            U = _cg_update(X, U, V, lam, max_inner, eps)
            V = _cg_update(XT, V, U, lam, max_inner, eps)
            losses.append(fs(_loss_terms(X, U, V))
                          + lam * (fs(torch.sum(U * U))
                                   + fs(torch.sum(V * V))))
    return U, V, losses


def _run_hand(X: BCSR, rank, lam, max_iter, max_inner, eps, seed):
    """Dense-mask torch baseline (hand-fused): materializes W=(X≠0) once."""
    m, n = X.shape
    Xd = X.todense()
    W = (Xd != 0).to(torch.float32)
    U, V = _init(m, n, rank, seed, X.device)

    def upd(Xd, W, U, V):
        return _cg(U, lambda U_: (W * (U_ @ V.T)) @ V - Xd @ V + lam * U_,
                   lambda p: (W * (p @ V.T)) @ V + lam * p, max_inner, eps)

    losses = []
    for _ in range(max_iter):
        U = upd(Xd, W, U, V)
        V = upd(Xd.T, W.T, V, U)
        losses.append(fs(torch.sum((W * (U @ V.T) - Xd) ** 2))
                      + lam * (fs(torch.sum(U * U))
                               + fs(torch.sum(V * V))))
    return U, V, losses
