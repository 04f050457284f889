"""Plain PyTorch K-Means (SystemML ``Kmeans.dml``, one run): Lloyd's
iterations from C0, squared distances ‖x‖² − 2xcᵀ + ‖c‖², each row
assigned to every centroid at its minimum (ties split evenly), the
within-cluster sum of squares recorded per iteration.  ``mm`` computes
every product with X (fp32, or TF32 for the control).  Imports nothing of
the program.
"""

from __future__ import annotations

import torch


def fit(ops: dict, fin: dict, cfg: dict, mm):
    X, C = ops["X"], fin["C0"]
    k = C.shape[0]
    xsq = torch.sum(X * X, dim=1, keepdim=True)
    hist = []
    for _ in range(cfg["kmeans_max_iter"]):
        D = xsq - 2.0 * mm(X, C.T) + torch.sum(C * C, dim=1)[None, :]
        dmin = D.min(dim=1, keepdim=True).values
        A = (D == dmin).to(torch.float32)
        A = A / A.sum(dim=1, keepdim=True)
        hist.append(float(torch.sum(dmin)))
        counts = A.sum(dim=0).reshape(k, 1)
        C_new = mm(A.T, X) / torch.clamp_min(counts, 1.0)
        done = float(torch.max(torch.abs(C_new - C))) < cfg["kmeans_eps"]
        C = C_new
        if done:
            break
    return {"C": C}, hist
