"""K-Means fits over a dense X: what the mix draws, the port's entry it
calls, and its work a fit.

The draw is a frozen copy of ``chip_smoke.py``'s ``kmeans_data`` at commit
f8ea0f9, seeded from the run's seed: X (m, n) around k planted centres
(``kmeans_centre_scale`` x N(0, 1)) with unit noise.  Each fit is a restart
from its own C0: k distinct rows of X drawn from the seed.
"""

from __future__ import annotations

import torch

from portbench import work


def draw(cfg: dict, seed: int, device) -> dict:
    m, n, k = cfg["rows"], cfg["cols"], cfg["kmeans_k"]
    g = torch.Generator(device=device).manual_seed(seed)
    centres = cfg["kmeans_centre_scale"] * torch.randn(
        (k, n), generator=g, device=device)
    asg = torch.randint(0, k, (m,), generator=g, device=device)
    X = centres[asg]
    X += torch.randn((m, n), generator=g, device=device)
    return {"X": X}


def fit_input(ops: dict, cfg: dict, rng) -> dict:
    """C0: ``kmeans_k`` distinct rows of X, their indices from ``rng``."""
    X = ops["X"]
    idx = rng.choice(X.shape[0], size=cfg["kmeans_k"], replace=False)
    rows = torch.as_tensor(idx, dtype=torch.long, device=X.device)
    return {"C0": X[rows].clone(), "rows": [int(i) for i in idx]}


def prepare(ops: dict, cfg: dict) -> dict:
    return ops


def port_fit(port_ops: dict, fin: dict, cfg: dict):
    from repro_torch.algos import kmeans
    C, objs = kmeans.run(port_ops["X"], fin["C0"],
                         max_iter=cfg["kmeans_max_iter"],
                         eps=cfg["kmeans_eps"], mode="gen", kernels="cuda",
                         device=str(port_ops["X"].device))
    return {"C": C}, objs


def regions(cfg: dict, meta) -> list:
    from repro_torch.algos import kmeans
    m, n, k = cfg["rows"], cfg["cols"], cfg["kmeans_k"]
    return [(kmeans._sq_rowsums, (meta(m, n),), False),
            (kmeans._min_dist, (meta(m, k), meta(m, 1), meta(1, k)), False)]


def fit_work(cfg: dict, ops: dict) -> tuple[int, int]:
    return work.kmeans_fit_work(cfg["rows"], cfg["cols"], cfg["kmeans_k"],
                                cfg["kmeans_max_iter"])
