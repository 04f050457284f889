"""Plain PyTorch L2SVM (SystemML ``l2-svm.dml``): conjugate directions
with an exact Newton line search over the squared hinge, λ·‖w‖²/2, from
w = 0.  ``mm`` computes every product with X (fp32, or TF32 for the
control); everything else is fp32 torch.  Imports nothing of the program.
"""

from __future__ import annotations

import torch


def fit(ops: dict, fin: dict, cfg: dict, mm):
    X, y = ops["X"], ops["y"]
    lam, eps = cfg["lam"], cfg["eps"]
    w = torch.zeros((X.shape[1], 1), dtype=torch.float32, device=X.device)

    def obj_grad(w):
        out = torch.clamp_min(1.0 - y * mm(X, w), 0.0)
        val = 0.5 * torch.sum(out * out) + 0.5 * lam * torch.sum(w * w)
        return val, -mm(X.T, out * y) + lam * w

    _val, g = obj_grad(w)
    s = -g
    objs = []
    for _ in range(cfg["l2svm_max_iter"]):
        Xs = mm(X, s)
        out = torch.clamp_min(1.0 - y * mm(X, w), 0.0)
        act = (out > 0).to(torch.float32)
        yXs = y * Xs
        num = float(torch.sum(act * out * yXs)) - lam * float(torch.sum(w * s))
        den = float(torch.sum(act * yXs * yXs)) + lam * float(torch.sum(s * s))
        w = w + (num / max(den, 1e-30)) * s
        val, g_new = obj_grad(w)
        objs.append(float(val))
        beta = float(torch.sum(g_new * g_new)) / max(float(torch.sum(g * g)),
                                                     1e-30)
        s = -g_new + beta * s
        g = g_new
        if float(torch.sum(g * g)) < eps:
            break
    return {"w": w}, objs
