"""Plain PyTorch ALS-CG (SystemML ``ALS-CG.dml``) over the stored blocks
of a block-sparse X: per outer iteration, conjugate-gradient updates of U
then V on the weighted squared loss Σ((X≠0)⊙(UVᵀ) − X)² + λ(‖U‖² + ‖V‖²)
(gradient ((X≠0)⊙(UVᵀ))V − XV + λU, Hessian action ((X≠0)⊙(sVᵀ))V + λs;
V's over Xᵀ), and the loss after each.  It works on the drawn blocks
themselves, a chunk of blocks at a time, and derives again what the
program derives: the starting U and V from the fit's seed (numpy, 0.1 ×
normal draws) and Xᵀ's blocks (each block transposed in place).  ``mm``
computes every product (fp32, or TF32 for the control).  Imports nothing
of the program.
"""

from __future__ import annotations

import numpy as np
import torch

#: stored blocks a chunk (a 128 x 128 chunk holds 1 GiB of products)
CHUNK = 16384


def _init(m: int, n: int, rank: int, seed: int, device):
    rng = np.random.default_rng(seed)
    U = torch.as_tensor(rng.normal(size=(m, rank)).astype(np.float32),
                        device=device) * 0.1
    V = torch.as_tensor(rng.normal(size=(n, rank)).astype(np.float32),
                        device=device) * 0.1
    return U, V


class Blocks:
    """X's stored blocks, walked a chunk at a time."""

    def __init__(self, ops: dict):
        self.data, self.bs = ops["data"], ops["bs"]
        self.rows = ops["rows"].long()
        self.cols = ops["cols"].long()
        self.shape = tuple(ops["shape"])

    def chunks(self):
        for a in range(0, self.data.shape[0], CHUNK):
            b = min(a + CHUNK, self.data.shape[0])
            yield self.data[a:b], self.rows[a:b], self.cols[a:b]

    def panels(self, A: torch.Tensor) -> torch.Tensor:
        """A (rows, r) as (rows / bs, bs, r) block panels."""
        return A.reshape(-1, self.bs, A.shape[1])

    def masked_mm(self, L, R, mm, transpose: bool):
        """Σ over stored blocks (i, j) of ((X≠0)⊙(L_i R_jᵀ)) R_j into row
        panel i (``transpose`` False: L over X's block rows, R over its
        block columns), or of the same over Xᵀ: ((Xᵀ≠0)⊙(L_j R_iᵀ)) R_i
        into panel j (L over X's block columns, R over its block rows)."""
        Lp, Rp = self.panels(L), self.panels(R)
        out = torch.zeros_like(Lp)
        for blk, ri, ci in self.chunks():
            li, rj = (ci, ri) if transpose else (ri, ci)
            Pm = (blk != 0).to(torch.float32)
            if transpose:
                Pm = Pm.transpose(1, 2)
            P = Pm * mm(Lp[li], Rp[rj].transpose(1, 2))
            out.index_add_(0, li, mm(P, Rp[rj]))
        return out.reshape(L.shape)

    def times(self, R, mm, transpose: bool):
        """X R (R over X's block columns), or Xᵀ R (R over its rows)."""
        Rp = self.panels(R)
        nout = self.shape[1] if transpose else self.shape[0]
        out = torch.zeros((nout // self.bs, self.bs, R.shape[1]),
                          dtype=torch.float32, device=R.device)
        for blk, ri, ci in self.chunks():
            if transpose:
                out.index_add_(0, ci, mm(blk.transpose(1, 2), Rp[ri]))
            else:
                out.index_add_(0, ri, mm(blk, Rp[ci]))
        return out.reshape(nout, R.shape[1])

    def loss(self, U, V, mm) -> float:
        Up, Vp = self.panels(U), self.panels(V)
        total = 0.0
        for blk, ri, ci in self.chunks():
            R = (blk != 0).to(torch.float32) * mm(
                Up[ri], Vp[ci].transpose(1, 2)) - blk
            total += float(torch.sum(R * R))
        return total


def _cg(U, grad, hvp, max_inner, eps):
    g = grad(U)
    d = torch.zeros_like(U)
    r = -g
    p = r
    rs = float(torch.sum(r * r))
    for _ in range(max_inner):
        Hp = hvp(p)
        alpha = rs / max(float(torch.sum(p * Hp)), 1e-30)
        d = d + alpha * p
        r = r - alpha * Hp
        rs_new = float(torch.sum(r * r))
        if rs_new < eps:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    return U + d


def fit(ops: dict, fin: dict, cfg: dict, mm):
    X = Blocks(ops)
    m, n = X.shape
    lam, eps, inner = cfg["lam"], cfg["eps"], cfg["als_max_inner"]
    U, V = _init(m, n, cfg["rank"], fin["seed"], X.data.device)
    losses = []
    for _ in range(cfg["als_max_iter"]):
        XV = X.times(V, mm, transpose=False)
        U = _cg(U, lambda U_: X.masked_mm(U_, V, mm, False) - XV + lam * U_,
                lambda p: X.masked_mm(p, V, mm, False) + lam * p, inner, eps)
        XtU = X.times(U, mm, transpose=True)
        V = _cg(V, lambda V_: X.masked_mm(V_, U, mm, True) - XtU + lam * V_,
                lambda p: X.masked_mm(p, U, mm, True) + lam * p, inner, eps)
        losses.append(X.loss(U, V, mm) + lam * (float(torch.sum(U * U))
                                                + float(torch.sum(V * V))))
    return {"U": U, "V": V}, losses
