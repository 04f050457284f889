"""L2SVM fits over a dense X: what the mix draws, the port's entry it
calls, and its work a fit.

The draw is a frozen copy of ``chip_smoke.py``'s ``l2svm_data`` at commit
f8ea0f9, seeded from the run's seed: X (m, n) standard normal and labels
±1 from a planted w plus ``label_noise`` noise.  Every fit starts from
w = 0 over the same X and y.
"""

from __future__ import annotations

import torch

from portbench import work


def draw(cfg: dict, seed: int, device) -> dict:
    m, n = cfg["rows"], cfg["cols"]
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((m, n), generator=g, device=device)
    w_true = torch.randn((n, 1), generator=g, device=device)
    noise = torch.randn((m, 1), generator=g, device=device)
    y = torch.where(X @ w_true + cfg["label_noise"] * noise >= 0, 1.0, -1.0)
    return {"X": X, "y": y}


def fit_input(ops: dict, cfg: dict, rng) -> dict:
    return {}


def prepare(ops: dict, cfg: dict) -> dict:
    return ops


def port_fit(port_ops: dict, fin: dict, cfg: dict):
    from repro_torch.algos import l2svm
    w, objs = l2svm.run(port_ops["X"], port_ops["y"], lam=cfg["lam"],
                        max_iter=cfg["l2svm_max_iter"], eps=cfg["eps"],
                        mode="gen", kernels="cuda",
                        device=str(port_ops["X"].device))
    return {"w": w}, objs


def regions(cfg: dict, meta) -> list:
    """The fused regions a fit calls, at its shapes: (region, args, plan
    the backward?)."""
    from repro_torch.algos import l2svm
    m, n = cfg["rows"], cfg["cols"]
    X, w, col, lam = meta(m, n), meta(n, 1), meta(m, 1), meta(1, 1)
    return [(l2svm._hinge, (X, w, col), False),
            (l2svm._search_terms, (col, col), False),
            (l2svm._objective_full, (X, w, col, lam), True)]


def fit_work(cfg: dict, ops: dict) -> tuple[int, int]:
    return work.l2svm_fit_work(cfg["rows"], cfg["cols"],
                               cfg["l2svm_max_iter"])
