"""ALS-CG fits over a block-sparse ratings matrix: what the mix draws, the
port's entry it calls, and its work a fit.

The draw follows ``chip_smoke.py``'s ``netflix_like`` at commit f8ea0f9
(built on the device block row by block row from the run's seed, the shape
padded to the block size, zero in the padding rows and columns), with the
ratings at the source's fill: each cell of the users x movies matrix is
rated with probability ``fill``, unstructured, so that every block is
stored (a 128 x 128 block holds ~193 ratings, and none is empty but with
probability e^-193).  A rating is a star, 1 to 5: a planted
rank-``planted_rank`` product scaled to unit spread around
``rating_mean``, plus ``noise``, rounded and clipped.  Each fit is a
restart from its own U and V seed, drawn from the run's seed.
"""

from __future__ import annotations

import math

import torch

from portbench import work


def padded(cfg: dict) -> tuple[int, int]:
    bs = cfg["block_size"]
    return tuple(-(-d // bs) * bs for d in (cfg["rows"], cfg["cols"]))


def draw(cfg: dict, seed: int, device) -> dict:
    bs, pr = cfg["block_size"], cfg["planted_rank"]
    m0, n0 = cfg["rows"], cfg["cols"]
    m, n = padded(cfg)
    mb, nbc = m // bs, n // bs
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.arange(mb, device=device).repeat_interleave(nbc)
    cols = torch.arange(nbc, device=device).repeat(mb)
    Ut = torch.randn((m, pr), generator=g, device=device) / math.sqrt(pr)
    Vt = torch.randn((n, pr), generator=g, device=device)
    Ut[m0:] = 0.0
    Vt[n0:] = 0.0
    live_r = (torch.arange(m, device=device) < m0).reshape(mb, bs, 1)
    live_c = (torch.arange(n, device=device) < n0).reshape(nbc, 1, bs)
    data = torch.empty((mb * nbc, bs, bs), device=device)
    step = 128                                 # block rows per chunk
    for r0 in range(0, mb, step):
        r1 = min(r0 + step, mb)
        a, b = r0 * nbc, r1 * nbc
        ri, ci = rows[a:b], cols[a:b]
        blk = torch.bmm(Ut.reshape(mb, bs, pr)[ri],
                        Vt.reshape(nbc, bs, pr)[ci].transpose(1, 2))
        blk += cfg["rating_mean"]
        blk += cfg["noise"] * torch.randn(blk.shape, generator=g,
                                          device=device)
        blk = blk.round_().clamp_(1.0, 5.0)
        rated = torch.rand(blk.shape, generator=g, device=device) \
            < cfg["fill"]
        rated &= live_r[ri] & live_c[ci]
        data[a:b] = blk * rated
        del blk, rated
    return {"data": data, "rows": rows.to(torch.int32),
            "cols": cols.to(torch.int32), "shape": (m, n), "bs": bs}


def fit_input(ops: dict, cfg: dict, rng) -> dict:
    """The seed of the fit's starting U and V."""
    return {"seed": int(rng.integers(0, 2 ** 31))}


def prepare(ops: dict, cfg: dict):
    """The port's BCSR over the drawn blocks, built once, as a user holds
    the ratings across restarts."""
    from repro_torch.kernels.blocksparse import BCSR
    return {"X": BCSR(ops["data"], ops["rows"], ops["cols"], ops["shape"],
                      ops["bs"])}


def port_fit(port_ops: dict, fin: dict, cfg: dict):
    from repro_torch.algos import als_cg
    X = port_ops["X"]
    U, V, losses = als_cg.run(X, rank=cfg["rank"], lam=cfg["lam"],
                              max_iter=cfg["als_max_iter"],
                              max_inner=cfg["als_max_inner"], eps=cfg["eps"],
                              mode="gen", kernels="cuda",
                              device=str(X.device), seed=fin["seed"])
    return {"U": U, "V": V}, losses


def regions(cfg: dict, meta) -> list:
    """The Outer regions over X and Xᵀ, planned on BCSR operands of the
    padded shape (the planner reads the shape and the block sparsity)."""
    from repro_torch.algos import als_cg
    from repro_torch.kernels.blocksparse import BCSR
    bs, r = cfg["block_size"], cfg["rank"]
    m, n = padded(cfg)

    def bcsr(rows, cols):
        nb = (rows // bs) * (cols // bs)        # every block is stored
        idx = torch.empty(nb, dtype=torch.int32, device="meta")
        return BCSR(meta(nb, bs, bs), idx, idx, (rows, cols), bs)

    X, XT = bcsr(m, n), bcsr(n, m)
    return [(als_cg._wsq_mm, (X, meta(m, r), meta(n, r)), False),
            (als_cg._wsq_mm, (XT, meta(n, r), meta(m, r)), False),
            (als_cg._loss_terms, (X, meta(m, r), meta(n, r)), False)]


def fit_work(cfg: dict, ops: dict) -> tuple[int, int]:
    bs = cfg["block_size"]
    nb = int(ops["rows"].numel())
    m, _n = padded(cfg)
    return work.als_fit_work(nb * bs * bs, nb, m // bs, cfg["rank"],
                             cfg["als_max_iter"], cfg["als_max_inner"])
