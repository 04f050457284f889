"""Two-layer sigmoid autoencoder (H1=500, H2=2, batch=512) — SystemML
`autoencoder-2layer.dml`.

Mini-batch SGD with momentum.  The whole forward (4 GEMMs + the
bias+activation Cell chains + the loss aggregate) is one fused region;
``torch.autograd.grad`` of it over the eight weights and biases runs the
planned gradient DAG, which regenerates the δ ⊙ h ⊙ (1−h) sprop chains as
fused backward operators (the paper's AutoEncoder fusion profile, §5.4).
"""

from __future__ import annotations

import numpy as np
import torch

from .util import fs
from repro_torch import spans
from repro_torch.core import ir, fused, FusionContext
from repro_torch.interop import to_torch


@fused
def _recon_loss(Xb, W1, b1, W2, b2, W3, b3, W4, b4):
    """Σ (dec(enc(Xb)) − Xb)² — the full forward as one expression DAG."""
    H1 = ir.sigmoid(Xb @ W1 + b1)
    H2 = ir.sigmoid(H1 @ W2 + b2)
    H3 = ir.sigmoid(H2 @ W3 + b3)
    O = H3 @ W4 + b4
    return ((O - Xb) ** 2).sum()


def _init(n: int, h1: int, h2: int, seed: int, device):
    """The reference's starting weights (the same numpy draws, He-scaled)
    and zero biases, in layer order."""
    rng = np.random.default_rng(seed)

    def init(i, o):
        return to_torch(rng.normal(size=(i, o)).astype(np.float32)
                        * np.sqrt(2.0 / i), device)

    Ws = [init(n, h1), init(h1, h2), init(h2, h1), init(h1, n)]
    bs = [torch.zeros((1, d), dtype=torch.float32, device=device)
          for d in (h1, h2, h1, n)]
    return Ws, bs


@spans.spanned("autoencoder.run")
def run(X, h1: int = 64, h2: int = 2, batch: int = 128, epochs: int = 1,
        lr: float = 0.1, mu: float = 0.9, mode: str = "gen",
        kernels: str = "cuda", device=None, seed: int = 0):
    """Returns ((Ws, bs), loss per step).

    ``X`` (m,n) may be a numpy array or a tensor; it moves to the
    context's device (``device``, by default the card).
    ``kernels="never"`` runs every fused operator through the torch-eager
    interpreter instead of the generated CUDA kernels."""
    ctx = FusionContext(mode=mode, kernels=kernels)
    if device is not None:
        ctx = ctx.with_(device=device)
    X = to_torch(X, ctx.device)
    if mode == "hand":
        return _run_hand(X, h1, h2, batch, epochs, lr, mu, seed)
    m, n = X.shape
    with spans.span("autoencoder.init"):
        Ws, bs = _init(n, h1, h2, seed, X.device)
    vel = [torch.zeros_like(w) for w in Ws]
    losses = []
    steps = max(1, (m // batch) * epochs)
    with ctx:
        def val_grads(Xb, Ws_, bs_):
            leaves = [t.detach().requires_grad_(True) for t in Ws_ + bs_]
            W, b = leaves[:4], leaves[4:]
            val = _recon_loss(Xb, W[0], b[0], W[1], b[1], W[2], b[2],
                              W[3], b[3])[0, 0] / batch
            grads = torch.autograd.grad(val, leaves)
            return val.detach(), grads[:4], grads[4:]

        for step in range(steps):
            lo = (step * batch) % max(m - batch, 1)
            Xb = X[lo:lo + batch]
            val, grads, dbs = val_grads(Xb, Ws, bs)
            losses.append(fs(val))
            for i in range(4):
                vel[i] = mu * vel[i] - lr * grads[i]
                Ws[i] = Ws[i] + vel[i]
                bs[i] = bs[i] - lr * dbs[i]
    return (Ws, bs), losses


def _run_hand(X, h1, h2, batch, epochs, lr, mu, seed):
    """Hand-written torch baseline: the forward and the backprop written
    out (the paper's 'Fused' arm)."""
    m, n = X.shape
    Ws, bs = _init(n, h1, h2, seed, X.device)
    vel = [torch.zeros_like(w) for w in Ws]
    sig = lambda z: 1 / (1 + torch.exp(-z))
    losses = []
    steps = max(1, (m // batch) * epochs)
    for step in range(steps):
        lo = (step * batch) % max(m - batch, 1)
        Xb = X[lo:lo + batch]
        H1 = sig(Xb @ Ws[0] + bs[0])
        H2 = sig(H1 @ Ws[1] + bs[1])
        H3 = sig(H2 @ Ws[2] + bs[2])
        O = H3 @ Ws[3] + bs[3]
        R = O - Xb
        losses.append(fs(torch.sum(R * R)) / batch)
        D4 = 2.0 * R / batch
        G4 = H3.T @ D4
        D3 = (D4 @ Ws[3].T) * H3 * (1 - H3)
        G3 = H2.T @ D3
        D2 = (D3 @ Ws[2].T) * H2 * (1 - H2)
        G2 = H1.T @ D2
        D1 = (D2 @ Ws[1].T) * H1 * (1 - H1)
        G1 = Xb.T @ D1
        grads = [G1, G2, G3, G4]
        dbs = [D1.sum(0, keepdim=True), D2.sum(0, keepdim=True),
               D3.sum(0, keepdim=True), D4.sum(0, keepdim=True)]
        for i in range(4):
            vel[i] = mu * vel[i] - lr * grads[i]
            Ws[i] = Ws[i] + vel[i]
            bs[i] = bs[i] - lr * dbs[i]
    return (Ws, bs), losses
