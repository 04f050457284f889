"""Plain PyTorch MLogReg (SystemML ``MultiLogReg.dml``): Newton steps on
the regularized multinomial log-likelihood, each solved by conjugate
gradient with Hessian-vector products Xᵀ(Q − P⊙rowSums(Q)), Q = P⊙(Xv),
from B = 0.  ``mm`` computes every product with X (fp32, or TF32 for the
control).  Imports nothing of the program.
"""

from __future__ import annotations

import torch


def fit(ops: dict, fin: dict, cfg: dict, mm):
    X, Y = ops["X"], ops["Y"]
    lam, eps = cfg["lam"], cfg["eps"]
    B = torch.zeros((X.shape[1], Y.shape[1]), dtype=torch.float32,
                    device=X.device)

    def probs(B):
        Z = mm(X, B)
        E = torch.exp(Z - Z.max(dim=1, keepdim=True).values)
        return E / E.sum(dim=1, keepdim=True)

    objs = []
    for _ in range(cfg["mlogreg_max_outer"]):
        P = probs(B)
        objs.append(-float(torch.sum(Y * torch.log(P + 1e-30)))
                    + 0.5 * lam * float(torch.sum(B * B)))
        G = mm(X.T, P - Y) + lam * B
        d = torch.zeros_like(B)
        r = -G
        p = r
        rs = float(torch.sum(r * r))
        for _ in range(cfg["mlogreg_max_inner"]):
            Q = P * mm(X, p)
            Hp = mm(X.T, Q - P * Q.sum(dim=1, keepdim=True)) + lam * p
            alpha = rs / max(float(torch.sum(p * Hp)), 1e-30)
            d = d + alpha * p
            r = r - alpha * Hp
            rs_new = float(torch.sum(r * r))
            if rs_new < eps:
                break
            p = r + (rs_new / rs) * p
            rs = rs_new
        B = B + d
    return {"B": B}, objs
