"""Quickstart on the PyTorch port: the staged fusion API on the ALS
expression (Expression 1), the counterpart of ``examples/quickstart.py``.

The optimizer pipeline is three explicit, inspectable stages —

    fused(fn).trace(*operands)   -> Traced    (HOP DAG, static shapes)
    Traced.plan(mode=, layout=)  -> Planned   (explore -> select; explain())
    Planned.compile()            -> Compiled  (generated fused operators)

— with ``@fused`` call syntax as sugar over the same path, and
``torch.autograd.grad`` working through compiled operators (the backward
pass is planned too).  On the card the fused operators are the generated
CUDA kernels; on the CPU (``--device cpu``) their plain versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import json

import numpy as np
import torch

from repro_torch.core import FusionContext, fused, ir, plan_cache_stats
from repro_torch.kernels.blocksparse import BCSR


def operands(n: int = 2048, rank: int = 32, seed: int = 0) -> dict:
    """The example's numpy operands (the reference example's draws at
    n = 2048): a 10 % block-sparse X of 128-blocks, U, V and r."""
    rng = np.random.default_rng(seed)
    nb = n // 128
    mask = np.kron(rng.random((nb, nb)) < 0.1, np.ones((128, 128)))
    Xd = (rng.normal(size=(n, n)) * mask).astype(np.float32)
    return dict(X=Xd,
                U=rng.normal(size=(n, rank)).astype(np.float32),
                V=rng.normal(size=(n, rank)).astype(np.float32),
                r=rng.normal(size=(n, 1)).astype(np.float32))


def als_expr(X, U, V, r):
    return (ir.neq0(X) * (U @ V.T)) @ V + 1e-6 * U * r


def sq_loss_expr(U, V):
    return ((U @ V.T) ** 2).sum()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2048,
                    help="rows and columns of X (a multiple of 128)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # -- 1. declare the expression over typed operands ------------------------
    als_update = fused(als_expr, sparsity={"X": 0.1})
    data = operands(args.n)
    binds = {k: torch.from_numpy(v).to(dev) for k, v in data.items()
             if k != "X"}
    binds["X"] = BCSR.from_dense(data["X"], bs=128).to(dev)
    ctx = FusionContext(mode="gen", device=args.device)

    with ctx:
        # -- 2. stage: trace once, inspect every candidate arm's cost ---------
        traced = als_update.trace(**binds)
        planned = traced.plan(mode="gen")
        report = planned.explain()
        for cand in report["candidates"]:
            mark = " <- selected" if cand["selected"] else ""
            print(f"{cand['mode']:5s} cost={cand['cost']:.6f}s "
                  f"fused_ops={cand['n_fused']}{mark}")
        print("winner operators:",
              json.dumps(report["winner"]["operators"], indent=1))

        # -- 3. compile + execute the generated fused operators ---------------
        op = planned.compile()
        out = op(**binds)
        Xd = torch.from_numpy(data["X"]).to(dev)
        U, V, r = binds["U"], binds["V"], binds["r"]
        ref = ((Xd != 0) * (U @ V.T)) @ V + 1e-6 * U * r
        err = float(torch.max(torch.abs(out - ref)))
        print(f"fused output {tuple(out.shape)}, max err vs dense "
              f"reference: {err:.2e}")

        # -- 4. sugar: the same operator through @fused call syntax -----------
        out2 = als_update(**binds)
        sugar = float(torch.max(torch.abs(out2 - out)))
        print("call-sugar max diff:", sugar)

        # -- 5. differentiate a fused region: the backward is planned too -----
        sq_loss = fused(sq_loss_expr)
        u = U.clone().requires_grad_(True)
        (gU,) = torch.autograd.grad(sq_loss(u, V).reshape(()), u)
        gref = 2.0 * (U @ V.T) @ V
        gerr = float(torch.max(torch.abs(gU - gref)) / torch.max(
            torch.abs(gref)))
        print("torch.autograd.grad through fused op, max rel err:", gerr)
    st = plan_cache_stats()
    print(f"plan cache: {st.hits} hits / {st.misses} misses "
          f"({st.size} operators)")
    scale = float(torch.max(torch.abs(ref)))
    assert err <= 1e-4 * scale, (err, scale)
    assert sugar == 0.0, sugar
    assert gerr <= 1e-4, gerr
    return {"candidates": report["candidates"],
            "winner": report["winner"]["operators"], "err": err,
            "grad_rel_err": gerr}


if __name__ == "__main__":
    main()
