"""One rank of the port's distributed CPU checks (``tests/test_torch_dist.py``).

Run as ``python tests/torch_dist_worker.py CASE RANK WORLD INIT OUTDIR``:
joins a gloo process group of WORLD ranks at the ``file://`` address INIT
(60 s timeout), builds ``Mesh({"data": WORLD}, device="cpu")`` and runs
CASE:

* ``all`` — the segment program, ``l2svm.run`` / ``mlogreg.run`` under
  the mesh, the hybrid gradient, the distributed Outer over a BCSR, the
  strict program, ``fuse_exprs`` of the segment program under the mesh
  and the fused loss under ``TrainConfig(fusion_layout=mesh)``, asserting
  what a rank can see (one segment step with ≥ 2 members, no recorded
  fallback, collectives launched, EXE005 on a plan costed for another
  mesh, the strict raise, the loss's segment steps each way) and writing
  its outputs to ``OUTDIR/rank<RANK>.npz`` for the parent to hold against
  the reference;
* ``raise`` — rank 3 raises before the first collective, the others
  enter it: the launcher must stop them.

It imports only the port.  The inputs come from :func:`inputs`, which the
parent calls too (numpy, fixed seeds).
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

import numpy as np


def _bcsr_dense(m, n, bs, seed, density=0.05):
    rng = np.random.default_rng(seed)
    mask = rng.random((m // bs, n // bs)) < density
    mask.flat[0] = True
    dense = (rng.normal(size=(m, n))
             * np.kron(mask, np.ones((bs, bs)))).astype(np.float32)
    return dense, rng.normal(size=(m, 8)).astype(np.float32), \
        rng.normal(size=(n, 8)).astype(np.float32)


def inputs() -> dict:
    """Every case's numpy inputs (fixed seeds)."""
    rng = np.random.default_rng(11)
    seg = [rng.normal(size=(1024, 32)).astype(np.float32) for _ in range(6)]
    seg.append(rng.normal(size=(10, 1)).astype(np.float32))
    rng = np.random.default_rng(5)
    X = rng.normal(size=(512, 20)).astype(np.float32)
    y = np.sign(rng.normal(size=(512, 1))).astype(np.float32)
    Xm = rng.normal(size=(400, 12)).astype(np.float32)
    Ym = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=400)]
    Bg = (rng.normal(size=(12, 4)) * 0.1).astype(np.float32)
    return {"seg": seg, "l2svm": (X, y), "mlogreg": (Xm, Ym),
            "grad": (Xm, Bg, Ym, np.full((1, 1), 1e-3, np.float32)),
            # 16 block rows: 2 a rank; 12: not partitionable across 8
            "outer": _bcsr_dense(2048, 512, 128, 13),
            "strict": _bcsr_dense(1536, 512, 128, 17),
            # the fused loss: 64 rows (8 a rank) of .reduced()'s vocabulary
            "ce": ce_inputs()}


def ce_inputs(rows: int = 64, vocab: int = 256):
    """Logits N(0, 2²) and targets of the fused-loss case (fixed seed)."""
    rng = np.random.default_rng(29)
    return ((2.0 * rng.standard_normal((rows, vocab))).astype(np.float32),
            rng.integers(0, vocab, size=(rows,)).astype(np.int32))


def segment_expr(ir):
    def expr(X1, X2, X3, X4, X5, X6, w):
        A = ir.sigmoid(X1 + X2 + X3 + X4 + X5 + X6)
        return ((A * X1 + X2).sum(), (A - X3).rowsums(),
                (A * A + X4).sum(), (w ** 2).sum())
    return expr


def outer_expr(ir):
    return lambda X, U, V: (ir.neq0(X) * (U @ V.T)) @ V


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def run_all(mesh, outdir: Path, rank: int) -> None:
    import torch
    from repro_torch.algos import l2svm, mlogreg
    from repro_torch.core import (Fused, FusionContext, PlanInvariantError,
                                  fused, ir)
    from repro_torch.kernels.blocksparse import BCSR

    data = inputs()
    ctx = FusionContext(mode="gen", device="cpu", kernels="never")
    out = {}

    # the segment program: one segment step of >= 2 members
    f = fused(segment_expr(ir))
    with ctx:
        planned = f.trace(*data["seg"]).plan(layout=mesh)
        segs = planned.explain()["distributed"]["segments"]
        _check(len(segs) == 1 and segs[0]["n_operators"] >= 2, segs)
        compiled = planned.compile()
        c0 = mesh.collectives
        outs = compiled(*data["seg"])
    sps = compiled._cplan._seg_plans
    _check(len(sps) == 1 and len(sps[0].items) >= 2,
           f"segment steps {[len(s.items) for s in sps]}")
    _check(compiled._cplan.fallbacks == [], compiled._cplan.fallbacks)
    _check(mesh.collectives > c0, "the segment launched no collective")
    for i, o in enumerate(outs):
        out[f"seg{i}"] = o.numpy()

    # the per-operator path: each distributed operator on the mesh alone
    # (build_dist_fn, its structural cache hit on the second call)
    from repro_torch.kernels import distributed
    with ctx:
        per_op = planned.compile(staged=False)
        c0 = mesh.collectives
        for _ in range(2):
            outs = per_op(*data["seg"])
    _check(mesh.collectives > c0 and per_op._cplan.fallbacks == [],
           per_op._cplan.fallbacks)
    _check(distributed._FN_CACHE, "no distributed operator was cached")
    for i, o in enumerate(outs):
        out[f"seg_per_op{i}"] = o.numpy()

    # a 2-D mesh: rows over "data" (4), the row group one of two
    from repro_torch.dist import Mesh
    mesh2 = Mesh({"data": 4, "model": 2}, device="cpu")
    with ctx:
        compiled2 = f.trace(*data["seg"]).plan(layout=mesh2).compile()
        c0 = mesh2.collectives
        outs = compiled2(*data["seg"])
    _check(compiled2._cplan._seg_plans and mesh2.collectives > c0
           and compiled2._cplan.fallbacks == [], "2-D mesh segment")
    for i, o in enumerate(outs):
        out[f"seg_2d{i}"] = o.numpy()

    # EXE005 replays the lowering against the real mesh: a plan costed for
    # 4 ranks cannot run on these 8, one costed for 8 can
    from repro_torch.core.verify import verify_exec
    from repro_torch.dist import LogicalMesh
    with ctx:
        p4 = f.trace(*data["seg"]).plan(layout=LogicalMesh({"data": 4}))
    exe005 = [d for d in verify_exec(p4.eplan, layout=mesh)
              if d.code == "EXE005"]
    _check(exe005 and all(d.severity == "error" for d in exe005), exe005)
    _check(not [d for d in verify_exec(planned.eplan, layout=mesh)
                if d.code == "EXE005"], "EXE005 on a realizable plan")

    # the algorithms under the mesh
    c0 = mesh.collectives
    w, objs = l2svm.run(*data["l2svm"], max_iter=4, kernels="never",
                        layout=mesh)
    _check(mesh.collectives > c0, "l2svm launched no collective")
    out["l2svm_w"], out["l2svm_objs"] = w.numpy(), np.asarray(objs)
    c0 = mesh.collectives
    B, nlls = mlogreg.run(*data["mlogreg"], max_outer=3, max_inner=5,
                          kernels="never", layout=mesh)
    _check(mesh.collectives > c0, "mlogreg launched no collective")
    out["mlogreg_B"], out["mlogreg_nlls"] = B.numpy(), np.asarray(nlls)

    # the hybrid gradient: the planned backward runs segments too
    X, Bg, Y, lam = (torch.tensor(a) for a in data["grad"])
    with ctx:
        comp = mlogreg._nll_obj_reg.trace(X=X, B=Bg, Y=Y, lam=lam).plan(
            layout=mesh).compile()
        Bt = Bg.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(comp(X, Bt, Y, lam)[0, 0], Bt)
    _check(comp._bwd_plans[("B",)]._seg_plans,
           "the backward ran no segment")
    _check(comp.explain()["execution"]["fallbacks"] == [],
           comp.explain()["execution"]["fallbacks"])
    out["grad"] = g.numpy()

    # the distributed Outer over a BCSR main: 2 block rows a rank
    fo = Fused(outer_expr(ir), sparsity={"X": 0.05})
    dense, U, V = data["outer"]
    Xs = BCSR.from_dense(dense, bs=128)
    with ctx:
        planned = fo.trace(X=Xs, U=U, V=V).plan(layout=mesh)
        ops = planned.explain()["winner"]["operators"]
        _check([(o["template"], o.get("placement")) for o in ops]
               == [("OUTER", "distributed")], ops)
        compiled = planned.compile()
        out["outer"] = compiled(X=Xs, U=U, V=V).numpy()
    _check(compiled._cplan._seg_plans, "the Outer ran no segment step")
    _check(compiled.explain()["execution"]["fallbacks"] == [],
           compiled.explain()["execution"]["fallbacks"])

    # the strict program: 12 block rows do not split across 8 ranks
    dense, U, V = data["strict"]
    Xs = BCSR.from_dense(dense, bs=128)
    with ctx:
        planned = fo.trace(X=Xs, U=U, V=V).plan(layout=mesh)
        _check([o.get("placement") for o in
                planned.explain()["winner"]["operators"]]
               == ["distributed"], "strict program not distributed")
        compiled = planned.compile()
        out["strict"] = compiled(X=Xs, U=U, V=V).numpy()
        fbs = compiled.explain()["execution"]["fallbacks"]
        _check(fbs and all(str(fb.get("reason", "")).strip() for fb in fbs)
               and any("not partitionable" in fb["reason"] for fb in fbs),
               fbs)
    try:
        with ctx.with_(layout=mesh, verify="strict"):
            fo.trace(X=Xs, U=U, V=V).plan().compile()(X=Xs, U=U, V=V)
    except PlanInvariantError as e:
        _check("abandoned at execution time" in str(e), str(e))
    else:
        raise AssertionError("strict did not raise on the abandoned "
                             "placement")
    # fuse_exprs under the mesh: the segment program's hand-built DAG
    from repro_torch.core import FusionLayout, fuse_exprs
    names = ["X1", "X2", "X3", "X4", "X5", "X6", "w"]
    leaves = {n: ir.matrix(n, v.shape) for n, v in zip(names, data["seg"])}
    binds = dict(zip(names, data["seg"]))
    with ctx.with_(layout=mesh):
        c0 = mesh.collectives
        outs = fuse_exprs(segment_expr(ir)(**leaves), binds)
    _check(mesh.collectives > c0, "fuse_exprs launched no collective")
    for i, o in enumerate(outs):
        out[f"fuse_exprs{i}"] = o.numpy()
    lay = FusionLayout(mesh, {"X1": ("data", None)})
    placed = lay.apply("X1", binds["X1"])
    _check(isinstance(placed, torch.Tensor) and placed.device == mesh.device
           and tuple(placed.shape) == binds["X1"].shape,
           "FusionLayout.apply did not keep the whole operand")
    try:
        with ctx.with_(layout=mesh, device="meta"):
            fuse_exprs(segment_expr(ir)(**leaves), binds)
    except ValueError as e:
        _check("mesh's device" in str(e), str(e))
    else:
        raise AssertionError("fuse_exprs ran on another device than the "
                             "mesh's")

    # the fused loss under fusion_layout=mesh: each rank's row panel
    from repro_torch.launch import train
    logits, targets = (torch.tensor(a) for a in data["ce"])
    tc = train.TrainConfig(fusion="gen", fusion_layout=mesh)
    train._LSE_OPS.clear()
    with ctx:
        L = logits.clone().requires_grad_(True)
        c0 = mesh.collectives
        loss = train._ce(L, targets, tc)
        (gL,) = torch.autograd.grad(loss, L)
    (op,) = train._LSE_OPS.values()
    (bwd,) = op._bwd_plans.values()
    _check(op._cplan._seg_plans and bwd._seg_plans,
           "the fused loss ran no segment step each way")
    _check(op.explain()["execution"]["fallbacks"] == [],
           op.explain()["execution"]["fallbacks"])
    _check(mesh.collectives > c0, "the fused loss launched no collective")
    out["ce_loss"], out["ce_grad"] = loss.detach().numpy(), gL.numpy()

    out["collectives"] = np.asarray(mesh.collectives)
    np.savez(outdir / f"rank{rank}.npz", **out)


def main(argv) -> int:
    case, rank, world, init, outdir = argv[1], int(argv[2]), int(argv[3]), \
        argv[4], Path(argv[5])
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from repro_torch.dist import Mesh
        mesh = Mesh({"data": world}, device="cpu")
        if case == "raise":
            if rank == 3:
                raise RuntimeError("rank 3 fails before the collective")
            mesh.all_reduce(torch.ones(1, 1), "psum")
        else:
            run_all(mesh, outdir, rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
