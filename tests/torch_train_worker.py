"""One rank of the sharded-training, dry-run and activation-rule CPU checks
(``tests/test_torch_{sharded_train,dryrun,activation_rules}.py``).

Run as ``python tests/torch_train_worker.py CASE RANK WORLD INIT OUTDIR
MESH``: joins a gloo process group of WORLD ranks at the ``file://``
address INIT (60 s timeout), builds ``Mesh(MESH)`` (JSON) on the CPU and
runs CASE, writing ``OUTDIR/<case><RANK>.json`` (and, on rank 0, ``.pt``
files of whole tensors):

* ``train`` (``{data: 2, model: 2}``) — for every model of
  :data:`GRAD_MODELS` (its parameters ``OUTDIR/params_<arch>.pt``, the
  reference's, written by the parent) placed by ``param_specs(...,
  serve=False)``, one sharded value-and-grad of :func:`batch` (``a2a``
  inside ``activation_rules(mesh, "dp")``): the loss, the ce and every
  gradient joined whole (``OUTDIR/grads_<model>.pt``); then
  :data:`STEPS` sharded ``make_train_step`` steps of minitron-4b with
  ``fusion="gen"`` against the same steps on one rank: the losses, grad
  norms and the rank's blocks of the parameters after them; the same
  sharded steps with ``fusion_layout`` a ``LogicalMesh`` of the step's
  shape (the loss's plan priced for it), and the step's own mesh refused;
* ``record`` (``{data: 2, model: 2}``) — :data:`RECORD_CELLS` measured by
  ``dryrun_lib.measure_cell`` on the live mesh and on a
  ``RecordingMesh`` of this rank's coordinates (``meta``): both
  collective records;
* ``rules`` (``{pod: 2, data: 2, model: 2}``) — the multi-row-axis
  repair: a minitron-4b of d_model 66 (``_fit`` keeps ``data`` and drops
  ``pod`` on its 66-wide dims) served through ``Engine(mesh=...,
  layout="auto")`` with ``serve_params`` off, its logits against the
  unsharded engine's; the sequence-parallel forward (logits, collective
  counts, and the loss's gradients) against the unsharded / ``"dp"``
  ones; ``moe_a2a`` of olmoe-1b-7b's layer 0 on each data block's tokens
  (``OUTDIR/a2a<RANK>.pt``).

It imports only the port.
"""

from __future__ import annotations

import datetime
import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np

#: model -> (arch, config change) of the gradient checks
GRAD_MODELS = {"minitron-4b": ("minitron-4b", {}),
               "olmoe-1b-7b": ("olmoe-1b-7b", {}),
               "olmoe-1b-7b-a2a": ("olmoe-1b-7b", {"moe_impl": "a2a"}),
               "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
               "xlstm-1.3b": ("xlstm-1.3b", {})}
#: the gradient checks' batch: B sequences of S tokens (B splits over data)
B, S = 4, 16
STEPS = 3
#: (name, arch, shape kind, batch, seq, variant) of the recording checks
RECORD_CELLS = (("minitron-decode", "minitron-4b", "decode", 4, 32,
                 {"serve_params": True}),
                ("olmoe-decode", "olmoe-1b-7b", "decode", 4, 32,
                 {"serve_params": True}),
                ("xlstm-decode-fsdp", "xlstm-1.3b", "decode", 4, 32, None),
                ("minitron-train", "minitron-4b", "train", 8, 16,
                 {"n_mb": 2}),
                ("olmoe-train", "olmoe-1b-7b", "train", 4, 16, None))
#: the two-row-axis model: 66 = 2·33 splits over data, not pod × data
D66 = {"d_model": 66}
A2A_TOKENS = 32                      # olmoe's tokens a data block


def config(arch: str, change: dict):
    from repro_torch.configs import get_config
    return replace(get_config(arch).reduced(), **change)


def batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int64),
            "targets": rng.integers(0, cfg.vocab,
                                    size=(B, S)).astype(np.int64)}


def _whole(mesh, spec, t):
    from repro_torch.dist import sharding as sh
    g = mesh.all_gather(t.detach().contiguous()[None], dim=0, over="all")
    return sh.join_shards(mesh, spec, dict(enumerate(g.unbind(0))))


def _model(cfg, arch, outdir):
    import torch
    from repro_torch.models import LM
    m = LM(cfg, device="cpu")
    m.load_state_dict(torch.load(outdir / f"params_{arch}.pt"))
    return m.requires_grad_(False)


def run_train(mesh, outdir: Path, rank: int) -> dict:
    import contextlib
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    res = {}
    for name, (arch, change) in GRAD_MODELS.items():
        cfg = config(arch, change)
        m = _model(cfg, arch, outdir)
        specs = sh.param_specs(mesh, cfg, m.state_dict())
        m.shard_(mesh, specs)
        loss_fn = train.make_loss_fn(m, cfg, train.TrainConfig())
        ctx = sh.activation_rules(mesh, "dp") if change.get("moe_impl") \
            == "a2a" else contextlib.nullcontext()
        mesh.log.reset()
        with ctx:
            blk = train.batch_block(mesh, cfg, batch(cfg), m)
            (loss, ce), grads = train._sharded_value_and_grad(
                loss_fn, dict(m.named_parameters()), blk, mesh)
        grads = train._reduce_grads(mesh, specs, grads)
        gnorm = float(train._global_norm(mesh, specs, grads))
        counts = mesh.log.record()["counts"]
        whole = {k: _whole(mesh, specs[k], g) for k, g in grads.items()}
        if rank == 0:
            torch.save(whole, outdir / f"grads_{name}.pt")
        res[name] = {"loss": float(loss), "ce": float(ce), "gnorm": gnorm,
                     "counts": counts}

    # sharded steps against one-rank steps (fusion "gen": the Row CPlan's
    # plain version on the CPU)
    arch = "minitron-4b"
    cfg = config(arch, {})
    tc = train.TrainConfig(fusion="gen")
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, cfg.vocab, size=(B, S)),
                "targets": rng.integers(0, cfg.vocab, size=(B, S))}
               for _ in range(STEPS)]
    one = _model(cfg, arch, outdir)
    p1 = dict(one.named_parameters())
    o1 = adamw.init(p1, tc.opt)
    step1 = train.make_train_step(one, cfg, tc)
    m = _model(cfg, arch, outdir)
    specs = sh.param_specs(mesh, cfg, m.state_dict())
    m.shard_(mesh, specs)
    ps = dict(m.named_parameters())
    os_ = adamw.init(ps, tc.opt)
    step = train.make_train_step(m, cfg, tc, mesh=mesh)
    trace = {"one": [], "sharded": []}
    for b in batches:
        p1, o1, met1 = step1(p1, o1, b)
        ps, os_, met = step(ps, os_, b)
        trace["one"].append([float(met1["loss"]), float(met1["grad_norm"])])
        trace["sharded"].append([float(met["loss"]), float(met["grad_norm"])])
    errs = {}
    top = max(float(v.abs().max()) for v in p1.values())
    for k, v in ps.items():
        want = sh.local_shard(mesh, specs[k], p1[k])
        errs[k] = float((v - want).abs().max()) / top
    res["steps"] = {"trace": trace, "param_err": max(errs.values()),
                    "in_place": all(ps[k] is p for k, p in
                                    m.named_parameters())}

    # the same sharded steps with fusion_layout a LogicalMesh of the
    # step's shape: it prices the loss's plan, which runs on the rank's
    # rows; the step's own mesh is refused
    from repro_torch.dist import LogicalMesh
    m = _model(cfg, arch, outdir)
    m.shard_(mesh, specs)
    ps = dict(m.named_parameters())
    os_ = adamw.init(ps, tc.opt)
    train._LSE_OPS.clear()
    step = train.make_train_step(m, cfg, replace(
        tc, fusion_layout=LogicalMesh(dict(mesh.shape))), mesh=mesh)
    layout_trace = []
    for b in batches:
        ps, os_, met = step(ps, os_, b)
        layout_trace.append([float(met["loss"]), float(met["grad_norm"])])
    priced = all(isinstance(op.planned.context.layout.mesh, LogicalMesh)
                 and op.planned.context.layout.mesh.shape == mesh.shape
                 and not op._cplan._seg_plans
                 for op in train._LSE_OPS.values())
    try:
        train.make_loss_fn(m, cfg, replace(tc, fusion_layout=mesh))
        refused = False
    except ValueError:
        refused = True
    res["layout_steps"] = {"trace": layout_trace, "priced": priced,
                           "n_ops": len(train._LSE_OPS),
                           "own_mesh_refused": refused}
    return res


def run_record(mesh, outdir: Path, rank: int) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import RecordingMesh
    from repro_torch.launch import dryrun_lib as dl
    res = {}
    for name, arch, kind, b, s, variant in RECORD_CELLS:
        cfg = config(arch, {})
        shape = ShapeConfig(name, s, b, kind)
        live = dl.measure_cell(arch, name, mesh, cfg=cfg, shape=shape,
                               variant=variant)
        rec = dl.measure_cell(arch, name,
                              RecordingMesh(mesh.shape, mesh.coords),
                              cfg=cfg, shape=shape, variant=variant)
        res[name] = {"live": live["collective_bytes_per_device"],
                     "recorded": rec["collective_bytes_per_device"],
                     "live_flops": live["flops_per_device"],
                     "recorded_flops": rec["flops_per_device"]}
    return res


def run_rules(mesh, outdir: Path, rank: int) -> dict:
    import torch
    from repro_torch.dist import planner, sharding as sh
    from repro_torch.launch import train
    from repro_torch.models import LM, moe
    from repro_torch.models.sharded import weights
    from repro_torch.serve import Engine, Request
    import torch_sharded_worker as sw
    res = {}

    # the repair: FSDP leaves gathered over part of the row axes
    cfg = config("minitron-4b", D66)
    base = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    base.requires_grad_(False)
    state = {k: v.clone() for k, v in base.state_dict().items()}
    plain = Engine(base, batch_slots=sw.SLOTS, max_len=sw.MAX_LEN)
    ps = sw.prompts(cfg)
    want_tokens = sw._serve(plain, Request, ps)
    want, fed = sw._logits(plain, ps[1])
    orig = planner.plan_layout
    planner.plan_layout = lambda *a, **k: replace(orig(*a, **k),
                                                  serve_params=False)
    try:
        m = LM(cfg, device="cpu")
        m.load_state_dict(state)
        eng = Engine(m, batch_slots=sw.SLOTS, max_len=sw.MAX_LEN, mesh=mesh,
                     layout="auto")
        got_tokens = sw._serve(eng, Request, ps)
        got, _ = sw._logits(eng, ps[1], teacher=fed)
    finally:
        planner.plan_layout = orig
    partial = sorted(k for k, s in eng.param_specs.items()
                     for e in s if sh.entry_axes(e) == ("data",))
    res["repair"] = {
        "rel_err": max(float((g - w).abs().max() / w.abs().max())
                       for g, w in zip(got, want)),
        "tokens": got_tokens, "unsharded": want_tokens,
        "partial_leaves": partial, "groups": eng.mesh.log.record()["groups"]}

    # sequence parallelism: logits, collectives, gradients
    cfg = config("minitron-4b", {})
    base = LM(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    base.requires_grad_(False)
    b = batch(cfg, seed=7)
    with torch.no_grad():
        want, _aux = base(torch.as_tensor(b["tokens"]))
    loss_fn = train.make_loss_fn(base, cfg, train.TrainConfig())
    (want_loss, _), want_g = train.value_and_grad(
        loss_fn, dict(base.named_parameters()), b)
    m = LM(cfg, device="cpu")
    m.load_state_dict(base.state_dict())
    specs = sh.param_specs(mesh, cfg, m.state_dict(), serve=True)
    m.shard_(mesh, specs)
    blk = train.batch_block(mesh, cfg, b, m)
    out = {}
    for mode in ("dp", "sp"):
        mesh.log.reset()
        with sh.activation_rules(mesh, mode), torch.no_grad():
            logits, _ = m(blk["tokens"])
        counts = mesh.log.record()["counts"]
        i, n = sh.block_index(mesh, sh.batch_spec(mesh, cfg, B)[0],
                              mesh.coords)
        k = B // n
        err = float((logits - want[i * k:(i + 1) * k]).abs().max()
                    / want.abs().max())
        with sh.activation_rules(mesh, mode):
            lf = train.make_loss_fn(m, cfg, train.TrainConfig())
            (loss, _), g = train._sharded_value_and_grad(
                lf, dict(m.named_parameters()), blk, mesh)
        g = train._reduce_grads(mesh, specs, g)
        top = max(float(v.abs().max()) for v in want_g.values())
        gerr = max(float((_whole(mesh, specs[k2], v) - want_g[k2])
                         .abs().max()) for k2, v in g.items()) / top
        out[mode] = {"rel_err": err, "counts": counts,
                     "loss": float(loss), "grad_err": gerr}
    out["want_loss"] = float(want_loss)
    res["sp"] = out

    # moe_a2a on each data block's tokens against the local dispatch
    cfg = config("olmoe-1b-7b", {"moe_impl": "a2a"})
    m = _model(cfg, "olmoe-1b-7b", outdir)
    specs = sh.param_specs(mesh, cfg, m.state_dict())
    m.shard_(mesh, specs)
    scope = m.shard.scope("layers.0.mlp.")
    part = mesh.part
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((mesh.n * A2A_TOKENS, cfg.d_model)) \
        .astype(np.float32)
    x = torch.as_tensor(xs[part * A2A_TOKENS:(part + 1) * A2A_TOKENS])
    mesh.log.reset()
    with sh.activation_rules(mesh, "dp"), torch.no_grad():
        y, aux = moe.moe_a2a(x, weights(m.layers[0]["mlp"], scope), cfg,
                             sh=scope)
    torch.save({"x": x, "y": y, "aux": aux, "part": part},
               outdir / f"a2a{rank}.pt")
    if rank == 0:
        np.save(outdir / "a2a_x.npy", xs)
    res["a2a"] = {"counts": mesh.log.record()["counts"]}
    return res


def main(argv) -> None:
    import torch
    import torch.distributed as dist
    case, rank, world, init, outdir, shape = argv[:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from repro_torch.dist import Mesh
        mesh = Mesh(json.loads(shape), device="cpu")
        run = {"train": run_train, "record": run_record,
               "rules": run_rules}[case]
        res = run(mesh, Path(outdir), rank)
        (Path(outdir) / f"{case}{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    main(sys.argv[1:])
