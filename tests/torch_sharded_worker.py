"""One rank of the sharded-engine CPU checks (``tests/test_torch_sharded_engine.py``).

Run as ``python tests/torch_sharded_worker.py CASE RANK WORLD INIT OUTDIR
MESH [DEVICE]``: joins a gloo process group of WORLD ranks at the
``file://`` address INIT (60 s timeout), builds ``Mesh(MESH)`` (JSON) on
DEVICE (default ``cpu``; ``cuda:0`` puts every rank on the one card) and
runs CASE:

* ``serve`` — for every model of :data:`MODELS` the mesh runs, and every
  layout (``fixed``, ``auto``, and on a mesh with data axes ``fsdp``: the
  planner's layout with ``serve_params`` off, so every FSDP-sharded leaf
  is gathered before use; for minitron also ``meta``: the fixed layout
  on a model built on the ``meta`` device, each block cut on demand by
  ``weights=``), serves :func:`prompts` through
  ``Engine(model, mesh=..., layout=...)`` and through the unsharded
  ``Engine`` of the same weights (``OUTDIR/params_<model>.pt``, written by
  the parent from the reference's parameters), then holds the logits of a
  prefill and four teacher-forced decode steps in one of its slots
  against the unsharded engine's, and counts its stored bytes against
  the planner's; on ``{"data": 1, "model": 1}`` everything must be equal
  bit for bit.  A ``fault`` run has rank 1 keep its partial sums of layer
  0's attention output (the all-reduce still runs, so no rank waits): its
  logits must miss.  ``minitron-4b-chunked`` (attention chunks of 4, so
  the 12-token prompts take the chunked path) runs the fixed layout on
  meshes with a model axis.  Then minitron serves the prompts at
  temperature :data:`SAMPLE_T` through the fixed layout and through the
  unsharded engine, both seeded :data:`SAMPLE_SEED` (key ``sampled``).
  Writes ``OUTDIR/rank<RANK>.json``; then serves with a deadline that has
  passed on rank 1's clock only, writing each request's end and the
  collectives it took to ``OUTDIR/deadline<RANK>.json``;
* ``raise`` — rank 1 raises before the first collective, the others
  enter it: the launcher must stop them.

It imports only the port.
"""

from __future__ import annotations

import datetime
import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np

#: model name -> (arch, config change)
MODELS = {"minitron-4b": ("minitron-4b", {}),
          "olmoe-1b-7b": ("olmoe-1b-7b", {}),
          "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
          "xlstm-1.3b": ("xlstm-1.3b", {}),
          # one KV head: replicated on a model axis of 2, which splits the
          # four query heads two a rank (both read KV head 0)
          "minitron-4b-mqa": ("minitron-4b", {"n_kv_heads": 1}),
          # chunked attention on the rank's heads: chunks of 4 divide the
          # 12-token prompts (the 7-token ones stay dense)
          "minitron-4b-chunked": ("minitron-4b", {"attn_chunk": 4})}
SLOTS, MAX_LEN, MAX_NEW = 4, 32, 6
PROMPT_LENS = (7, 12, 7, 12, 7)      # five requests: one slot reused
#: the sampled serve's temperature and the engines' seed
SAMPLE_T, SAMPLE_SEED = 1.0, 11


def config(name: str, get_config):
    arch, change = MODELS[name]
    return replace(get_config(arch).reduced(), **change)


def prompts(cfg) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, size=p).astype(np.int32)
            for p in PROMPT_LENS]


def _serve(engine, request_cls, ps, temperature: float = 0.0) -> list:
    reqs = [request_cls(prompt=p, max_new=MAX_NEW, temperature=temperature)
            for p in ps]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    if not all(r.done and r.error is None for r in reqs):
        raise AssertionError("a request did not finish")
    return [r.out for r in reqs]


def _logits(engine, prompt, teacher=None) -> tuple:
    """Prefill ``prompt`` into the engine's first own slot (recurrent state
    zeroed) and decode four steps, feeding ``teacher``'s tokens (default:
    its own argmax); returns (the five logits, the fed tokens)."""
    import torch
    from repro_torch.serve.engine import RECURRENT_LEAVES
    i = engine.slot0
    cache = engine._slot_cache(i)
    for layer in cache["blocks"] + cache["rest"]:
        for k in RECURRENT_LEAVES:
            if k in layer:
                layer[k].zero_()
    dev = engine.model.device
    toks = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)[None]
    out, _ = engine._prefill(toks, cache)
    outs, fed = [out.cpu()], []
    for s in range(4):
        tok = int(torch.argmax(outs[-1][0, -1])) if teacher is None \
            else teacher[s]
        fed.append(tok)
        _nxt, lg, _ = engine._decode(cache, torch.full((1, 1), tok,
                                                       device=dev),
                                     len(prompt) + s)
        outs.append(lg.cpu())
    return outs, fed


def _planner_bytes(engine, cfg) -> float:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import LogicalMesh, planner
    mesh = LogicalMesh(engine.mesh.shape)
    shape = ShapeConfig("engine_decode", MAX_LEN, SLOTS, "decode")
    params, cache = planner._abstract_state(cfg, shape)
    return (planner._tree_accounting(mesh, engine.param_specs,
                                     params)["stored"]
            + planner._tree_accounting(mesh, engine.cache_specs,
                                       cache)["stored"])


def run_serve(mesh, outdir: Path, rank: int) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import planner
    from repro_torch.models import LM, sharded
    from repro_torch.serve import Engine, Request

    def load(cfg, name):
        m = LM(cfg, device=mesh.device)
        m.load_state_dict(torch.load(outdir / f"params_{name}.pt"))
        return m

    bitwise = mesh.shape == {"data": 1, "model": 1}
    layouts = ["fixed", "auto"] + (["fsdp"] if mesh.n > 1 else [])
    only = {"minitron-4b-mqa": mesh.shape == {"data": 1, "model": 2},
            "minitron-4b-chunked": mesh.tp > 1}
    names = [n for n in MODELS if only.get(n, True)]
    res = {}
    for name in names:
        cfg = config(name, get_config)
        ps = prompts(cfg)
        plain = Engine(load(cfg, name), batch_slots=SLOTS, max_len=MAX_LEN)
        want = _serve(plain, Request, ps)
        want_logits, fed = _logits(plain, ps[1])
        runs = [(lay, False) for lay in layouts]
        if name == "minitron-4b-chunked":
            runs = [("fixed", False)]
        if name == "minitron-4b":
            runs.append(("meta", False))
            if mesh.tp > 1:
                runs.append(("fixed", True))
        for lay, fault in runs:
            orig = planner.plan_layout
            if lay == "fsdp":            # the planner's, serve_params off
                planner.plan_layout = lambda *a, **k: replace(
                    orig(*a, **k), serve_params=False)
            if fault:
                real = sharded.Scope.reduce

                def reduce(self, y, real=real):
                    out = real(self, y)
                    if mesh.rank == 1 and self.prefix == "layers.0.inner.":
                        return y         # its partial sums, not the sum
                    return out
                sharded.Scope.reduce = reduce
            try:
                if lay == "meta":        # no values: each block cut on demand
                    whole = torch.load(outdir / f"params_{name}.pt")
                    eng = Engine(LM(cfg, device="meta"), batch_slots=SLOTS,
                                 max_len=MAX_LEN, mesh=mesh,
                                 weights=lambda k, index: whole[k][index])
                else:
                    m = LM(cfg, device="cpu")    # placed from the host
                    m.load_state_dict(torch.load(outdir / f"params_{name}.pt"))
                    eng = Engine(m, batch_slots=SLOTS, max_len=MAX_LEN,
                                 mesh=mesh,
                                 layout="auto" if lay == "fsdp" else lay)
                c0 = mesh.collectives
                got = _serve(eng, Request, ps)
                n_coll = mesh.collectives - c0
                got_logits, _ = _logits(eng, ps[1], teacher=fed)
            finally:
                planner.plan_layout = orig
                if fault:
                    sharded.Scope.reduce = real
            errs = [float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(got_logits, want_logits)]
            if bitwise and not all(torch.equal(g, w) for g, w in
                                   zip(got_logits, want_logits)):
                raise AssertionError(f"{name} {lay}: logits not bit equal")
            key = f"{name}/{lay}" + ("/fault" if fault else "")
            res[key] = {
                "tokens": got, "unsharded": want, "rel_err": max(errs),
                "stored": sum(eng.stored_bytes().values()),
                "planner_stored": _planner_bytes(eng, cfg),
                "layout": eng.layout.to_dict() if eng.layout else None,
                "serve_params": not eng.model.shard.fsdp,
                "collectives": n_coll, "slot0": eng.slot0,
                "n_local": eng.n_local}

    # temperature sampling: the sharded engine draws as the unsharded one
    cfg = config("minitron-4b", get_config)
    ps = prompts(cfg)
    plain = Engine(load(cfg, "minitron-4b"), batch_slots=SLOTS,
                   max_len=MAX_LEN, seed=SAMPLE_SEED)
    m = LM(cfg, device="cpu")
    m.load_state_dict(torch.load(outdir / "params_minitron-4b.pt"))
    eng = Engine(m, batch_slots=SLOTS, max_len=MAX_LEN, mesh=mesh,
                 seed=SAMPLE_SEED)
    res["sampled"] = {"tokens": _serve(eng, Request, ps, SAMPLE_T),
                      "unsharded": _serve(plain, Request, ps, SAMPLE_T)}
    (outdir / f"rank{rank}.json").write_text(json.dumps(res))

    # deadlines on every rank's clock: rank 1's passes at once, the
    # others' in an hour; every rank must expire every request alike
    cfg = config("minitron-4b", get_config)
    m = LM(cfg, device="cpu")
    m.load_state_dict(torch.load(outdir / "params_minitron-4b.pt"))
    eng = Engine(m, batch_slots=SLOTS, max_len=MAX_LEN, mesh=mesh,
                 default_deadline_s=0.0 if rank == 1 else 3600.0)
    reqs = [Request(prompt=p, max_new=MAX_NEW) for p in prompts(cfg)]
    for r in reqs:
        eng.submit(r)
    c0 = mesh.collectives
    eng.run_until_done()
    (outdir / f"deadline{rank}.json").write_text(json.dumps(
        {"ends": [[r.done, type(r.error).__name__, len(r.out)]
                  for r in reqs],
         "collectives": mesh.collectives - c0}))


def main(argv) -> None:
    import torch
    import torch.distributed as dist
    case, rank, world, init, outdir, shape = argv[:6]
    device = argv[6] if len(argv) > 6 else "cpu"
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from repro_torch.dist import Mesh
        mesh = Mesh(json.loads(shape), device=device)
        if case == "serve":
            run_serve(mesh, Path(outdir), rank)
        elif case == "raise":
            if rank == 1:
                raise RuntimeError("rank 1 fails before the collective")
            mesh.all_reduce(torch.ones(4), over="all")
        else:
            raise ValueError(case)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
