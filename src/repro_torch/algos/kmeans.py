"""K-Means (Lloyd's, 1 run, k=5) — SystemML `Kmeans.dml`.

Fusion sites: the squared row norms of X, and the distance-matrix
post-processing chain D = rowSums(X²) − 2·XCᵀ + rowSums(C²)ᵀ with the
row-min reduction (Row).  The assignment matmuls stay basic GEMMs.

The assignment compares D, computed by torch outside the fused operator,
with the row minimum the fused operator returns.  Both evaluate the same
fp32 operations in the same order (2·XC is exact, so a contracted
xsq − 2·XC rounds once either way), so every row finds its minimum.
"""

from __future__ import annotations

import torch

from .util import fs
from repro_torch import spans
from repro_torch.core import fused, FusionContext
from repro_torch.interop import to_torch


@fused
def _sq_rowsums(X):
    return (X ** 2).rowsums()


@fused
def _min_dist(XC, xsq, csq):
    """Row-wise min over D = xsq − 2·XC + csqᵀ (distances to centroids)."""
    D = xsq - 2.0 * XC + csq
    return D._agg("min", "row")


@spans.spanned("kmeans.run")
def run(X, C0, max_iter: int = 20, eps: float = 1e-12, mode: str = "gen",
        kernels: str = "cuda", device=None):
    """Returns (C, within-cluster sum of squares per iteration).

    ``X`` (m,n) and the starting centroids ``C0`` (k,n) may be numpy
    arrays or tensors; they move to the context's device (``device``, by
    default the card).  ``kernels="never"`` runs every fused operator
    through the torch-eager interpreter instead of the generated CUDA
    kernels."""
    ctx = FusionContext(mode=mode, kernels=kernels)
    if device is not None:
        ctx = ctx.with_(device=device)
    with spans.span("kmeans.init"):
        X, C0 = to_torch(X, ctx.device), to_torch(C0, ctx.device)
    if mode == "hand":
        return _run_hand(X, C0, max_iter, eps)
    m, n = X.shape
    k = C0.shape[0]
    C = C0
    wcss_hist = []
    with ctx:
        xsq = _sq_rowsums(X)                       # constant across iters
        for _ in range(max_iter):
            XC = X @ C.T                           # basic GEMM
            csq = torch.sum(C * C, dim=1).reshape(1, k)
            dmin = _min_dist(XC, xsq, csq)
            # hard assignment (argmin) — data movement, not LA: torch
            D = xsq - 2.0 * XC + csq
            A = (D == dmin).to(torch.float32)
            A = A / A.sum(dim=1, keepdim=True)     # break ties evenly
            wcss = fs(torch.sum(dmin))
            wcss_hist.append(wcss)
            counts = A.sum(dim=0).reshape(k, 1)
            C_new = (A.T @ X) / torch.clamp_min(counts, 1.0)
            if fs(torch.max(torch.abs(C_new - C))) < eps:
                C = C_new
                break
            C = C_new
    return C, wcss_hist


def _run_hand(X, C0, max_iter, eps):
    """Hand-written torch baseline (the paper's 'Fused' arm)."""
    m, n = X.shape
    k = C0.shape[0]
    C = C0
    xsq = torch.sum(X * X, dim=1, keepdim=True)
    hist = []
    for _ in range(max_iter):
        D = xsq - 2.0 * (X @ C.T) + torch.sum(C * C, dim=1)[None, :]
        dmin = D.min(dim=1, keepdim=True).values
        A = (D == dmin).to(torch.float32)
        A = A / A.sum(dim=1, keepdim=True)
        hist.append(fs(torch.sum(dmin)))
        counts = A.sum(dim=0).reshape(k, 1)
        C_new = (A.T @ X) / torch.clamp_min(counts, 1.0)
        if fs(torch.max(torch.abs(C_new - C))) < eps:
            C = C_new
            break
        C = C_new
    return C, hist
