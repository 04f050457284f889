"""MLogReg fits over a dense X: what the mix draws, the port's entry it
calls, and its work a fit.

The draw is a frozen copy of ``chip_smoke.py``'s ``mlogreg_data`` at commit
f8ea0f9, seeded from the run's seed: X (m, n) standard normal and one-hot
labels (m, k) from a planted B plus ``label_noise`` noise on the logits.
Every fit starts from B = 0 over the same X and Y.
"""

from __future__ import annotations

import torch

from portbench import work


def draw(cfg: dict, seed: int, device) -> dict:
    m, n, k = cfg["rows"], cfg["cols"], cfg["mlogreg_classes"]
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((m, n), generator=g, device=device)
    B = torch.randn((n, k), generator=g, device=device)
    noise = torch.randn((m, k), generator=g, device=device)
    idx = torch.argmax(X @ B + cfg["label_noise"] * noise, dim=1,
                       keepdim=True)
    Y = torch.zeros((m, k), device=device).scatter_(1, idx, 1.0)
    return {"X": X, "Y": Y}


def fit_input(ops: dict, cfg: dict, rng) -> dict:
    return {}


def prepare(ops: dict, cfg: dict) -> dict:
    return ops


def port_fit(port_ops: dict, fin: dict, cfg: dict):
    from repro_torch.algos import mlogreg
    B, objs = mlogreg.run(port_ops["X"], port_ops["Y"], lam=cfg["lam"],
                          max_outer=cfg["mlogreg_max_outer"],
                          max_inner=cfg["mlogreg_max_inner"], eps=cfg["eps"],
                          mode="gen", kernels="cuda",
                          device=str(port_ops["X"].device))
    return {"B": B}, objs


def regions(cfg: dict, meta) -> list:
    from repro_torch.algos import mlogreg
    m, n, k = cfg["rows"], cfg["cols"], cfg["mlogreg_classes"]
    X = meta(m, n)
    return [(mlogreg._probs, (X, meta(n, k)), False),
            (mlogreg._nll_obj_reg, (X, meta(n, k), meta(m, k), meta(1, 1)),
             True),
            (mlogreg._hvp, (X, meta(n, k), meta(m, k)), False)]


def fit_work(cfg: dict, ops: dict) -> tuple[int, int]:
    return work.mlogreg_fit_work(cfg["rows"], cfg["cols"],
                                 cfg["mlogreg_classes"],
                                 cfg["mlogreg_max_outer"],
                                 cfg["mlogreg_max_inner"])
