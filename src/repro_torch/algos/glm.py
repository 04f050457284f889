"""GLM, binomial-probit — SystemML `GLM.dml` (dfam=2, link=probit) via
iteratively re-weighted least squares with an inner CG solve.

Fusion sites: the probit link/mean/variance chain over η (Cell; erf-based,
two roots), the working-response cross-product Xᵀ(w⊙r) and the weighted
cross-products Xᵀ(w⊙Xv) (Row), and the deviance aggregate.
"""

from __future__ import annotations

import math

import torch

from .util import fs
from repro_torch import spans
from repro_torch.core import ir, fused, FusionContext
from repro_torch.interop import to_torch

_SQRT2 = math.sqrt(2.0)
_SQRT2PI = math.sqrt(2.0 * math.pi)


@fused
def _link_chain(eta, y):
    """mu, dens, working weight w = dens²/var, working residual r."""
    mu = 0.5 * (ir.erf(eta / _SQRT2) + 1.0)
    mu = ir.minimum(ir.maximum(mu, 1e-7), 1.0 - 1e-7)
    dens = ir.exp(-0.5 * eta * eta) / _SQRT2PI
    var = mu * (1.0 - mu)
    w = dens * dens / var
    r = (y - mu) / ir.maximum(dens, 1e-30)
    return w, r


@fused
def _wxv(X, w, v):
    """Xᵀ (w ⊙ (X v)) — the IRLS normal-equation HVP (Row template)."""
    return X.T @ (w * (X @ v))


@fused
def _wz(X, w, r):
    return X.T @ (w * r)


@fused
def _deviance(y, eta):
    mu = 0.5 * (ir.erf(eta / _SQRT2) + 1.0)
    mu = ir.minimum(ir.maximum(mu, 1e-7), 1.0 - 1e-7)
    return (y * ir.log(mu) + (1.0 - y) * ir.log(1.0 - mu)).sum()


@spans.spanned("glm.run")
def run(X, y, lam: float = 1e-3, max_outer: int = 8, max_inner: int = 10,
        eps: float = 1e-12, mode: str = "gen", kernels: str = "cuda",
        device=None):
    """Returns (beta, deviance per outer iteration).

    ``X`` (m,n) and ``y`` ∈ {0,1} (m,1) may be numpy arrays or tensors;
    they move to the context's device (``device``, by default the card).
    ``kernels="never"`` runs every fused operator through the torch-eager
    interpreter instead of the generated CUDA kernels."""
    ctx = FusionContext(mode=mode, kernels=kernels)
    if device is not None:
        ctx = ctx.with_(device=device)
    with spans.span("glm.init"):
        X, y = to_torch(X, ctx.device), to_torch(y, ctx.device)
    if mode == "hand":
        return _run_hand(X, y, lam, max_outer, max_inner, eps)
    m, n = X.shape
    beta = torch.zeros((n, 1), dtype=torch.float32, device=X.device)
    devs = []
    with ctx:
        for _ in range(max_outer):
            eta = X @ beta                    # basic GEMV
            w, r = _link_chain(eta, y)
            devs.append(-2.0 * fs(_deviance(y, eta)))
            rhs = _wz(X, w, r) - lam * beta
            # CG on (XᵀWX + lam I) d = rhs
            d = torch.zeros_like(beta)
            res = rhs
            p = res
            rs = fs(torch.sum(res * res))
            for _ in range(max_inner):
                Hp = _wxv(X, w, p) + lam * p
                alpha = rs / max(fs(torch.sum(p * Hp)), 1e-30)
                d = d + alpha * p
                res = res - alpha * Hp
                rs_new = fs(torch.sum(res * res))
                if rs_new < eps:
                    break
                p = res + (rs_new / rs) * p
                rs = rs_new
            beta = beta + d
    return beta, devs


def _run_hand(X, y, lam, max_outer, max_inner, eps):
    """Hand-written torch baseline (the paper's 'Fused' arm)."""
    m, n = X.shape
    beta = torch.zeros((n, 1), dtype=torch.float32, device=X.device)
    devs = []
    for _ in range(max_outer):
        eta = X @ beta
        mu = torch.clamp(0.5 * (torch.special.erf(eta / _SQRT2) + 1.0),
                         1e-7, 1 - 1e-7)
        dens = torch.exp(-0.5 * eta * eta) / _SQRT2PI
        w = dens * dens / (mu * (1 - mu))
        r = (y - mu) / torch.clamp_min(dens, 1e-30)
        devs.append(-2.0 * fs(torch.sum(y * torch.log(mu)
                                        + (1 - y) * torch.log(1 - mu))))
        rhs = X.T @ (w * r) - lam * beta
        d = torch.zeros_like(beta)
        res = rhs
        p = res
        rs = fs(torch.sum(res * res))
        for _ in range(max_inner):
            Hp = X.T @ (w * (X @ p)) + lam * p
            alpha = rs / max(fs(torch.sum(p * Hp)), 1e-30)
            d = d + alpha * p
            res = res - alpha * Hp
            rs_new = fs(torch.sum(res * res))
            if rs_new < eps:
                break
            p = res + (rs_new / rs) * p
            rs = rs_new
        beta = beta + d
    return beta, devs
