"""Synthetic data generators for the algorithm suite (paper §5.1 'rand and
algorithm-specific data generation scripts').  The numbers are the
reference's: the same numpy generator, the same seed, the same draws."""

from __future__ import annotations

import numpy as np

from repro_torch.interop import resolve_device, to_torch
from repro_torch.kernels.blocksparse import BCSR


def classification(m: int, n: int, k: int = 2, seed: int = 0,
                   sparsity: float = 1.0, device="cuda"):
    """Linearly-separable-ish multiclass data; labels one-hot (m,k) and
    binary ±1 (m,1) for 2-class, as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, n)).astype(np.float32)
    if sparsity < 1.0:
        X *= (rng.random((m, n)) < sparsity)
    w_true = rng.normal(size=(n, k)).astype(np.float32)
    logits = X @ w_true + 0.5 * rng.normal(size=(m, k)).astype(np.float32)
    y_idx = logits.argmax(axis=1)
    Y = np.eye(k, dtype=np.float32)[y_idx]
    y_pm = (2.0 * (y_idx == 0) - 1.0).astype(np.float32).reshape(m, 1)
    return to_torch((X, Y, y_pm), device)


def ratings(m: int, n: int, rank: int = 8, bs: int = 128,
            block_density: float = 0.25, seed: int = 0, device="cuda"):
    """Low-rank block-sparse rating matrix (ALS-CG input) as a BCSR on
    ``device``: the reference's draws, so the same blocks and values."""
    rng = np.random.default_rng(seed)
    mb, nb = m // bs, n // bs
    Ut = rng.normal(size=(m, rank)).astype(np.float32) / np.sqrt(rank)
    Vt = rng.normal(size=(n, rank)).astype(np.float32) / np.sqrt(rank)
    mask = rng.random((mb, nb)) < block_density
    mask.flat[0] = True
    dense = (Ut @ Vt.T + 0.1 * rng.normal(size=(m, n))).astype(np.float32)
    dense *= np.kron(mask, np.ones((bs, bs), np.float32))
    return BCSR.from_dense(dense, bs=bs).to(resolve_device(device))


def regression(m: int, n: int, seed: int = 0, device="cuda"):
    """Binary-response data (GLM input): X (m,n) and y ∈ {0,1} (m,1) drawn
    from a logistic model, as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, n)).astype(np.float32)
    w = rng.normal(size=(n, 1)).astype(np.float32)
    p = 1 / (1 + np.exp(-(X @ w)))
    y = (rng.random((m, 1)) < p).astype(np.float32)
    return to_torch((X, y), device)


def clusters(m: int, n: int, k: int = 5, seed: int = 0, device="cuda"):
    """K-Means data: X (m,n) around k planted centres (k,n), as tensors on
    ``device``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, n)).astype(np.float32) * 4.0
    asg = rng.integers(0, k, size=m)
    X = centers[asg] + rng.normal(size=(m, n)).astype(np.float32)
    return to_torch((X, centers), device)


def images(m: int, n: int, seed: int = 0, device="cuda"):
    """MNIST-shaped autoencoder input: (m,n) in [0,1), a quarter of the
    cells non-zero, as a tensor on ``device``."""
    rng = np.random.default_rng(seed)
    X = (rng.random((m, n)) < 0.25) * rng.random((m, n))
    return to_torch(X.astype(np.float32), device)
