"""Training step factory and the training CLI (the reference's
``repro.launch.train``).

``make_train_step`` builds the step: microbatch gradient accumulation in
fp32 (the reference's ``lax.scan`` is a Python loop here), the
softmax-CE loss fused through the paper's planner (Row template) when
``fusion`` is enabled — on the card, the loss's forward and its planned
backward each run as one launch of the generated Row kernel — and the
AdamW update.  The step takes a dict of parameters (the model's
``named_parameters`` names, run through ``torch.func.functional_call``)
and writes the update into the tensors it is given, which the reference's
CLI gets by donating its buffers to the jitted step (``donate_argnums``):
the step's state lives once on the card.

With ``mesh=`` (a :class:`~repro_torch.dist.Mesh`, or a
:class:`~repro_torch.dist.RecordingMesh` in the dry-run) the step runs
one rank's part of the reference's global SPMD step on a model placed by
``LM.shard_`` (FSDP × TP, ``sh.param_specs(..., serve=False)``): the
rank's data block of each microbatch, the forward and backward on the
rank's blocks with the collectives' differentiable forms
(:mod:`repro_torch.models.sharded`), the fused loss on the rank's rows,
the loss averaged over the row group, FSDP leaves' gradients reduce-scattered by
the backward and the others all-reduced over the row axes they are
replicated on, the global gradient norm with every block counted once,
and AdamW on the rank's blocks.

The CLI runs on one device, or over the ranks of a process group
(``--ranks N`` starts them through ``dist.launch.run_ranks``) on
``launch.mesh.make_host_mesh``: checkpoints hold whole leaves in the
one-device format (rank 0 writes them), and a restore cuts each rank's
blocks, so either kind of run resumes the other's.
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch
from torch.func import functional_call

from repro_torch import spans
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import FusionLayout, current_context, fused, ir
from repro_torch.core.layout import layout_signature
from repro_torch.models import LM, lm_loss
from repro_torch.models.lm import N_PATCHES
from repro_torch.optim import adamw


@dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    moe_aux_weight: float = 0.01
    fusion: str = "off"          # off | gen | fa | fnr  (planner arm)
    #: mesh or FusionLayout for the fused-loss planner: the LSE Row chain
    #: iterates flattened (B·S) token rows, so under a layout the planner
    #: may place it distributed (row-partitioned, no collective).  Under a
    #: ``LogicalMesh`` the plan is priced for the mesh and runs locally; on
    #: a ``Mesh`` of ranks each rank runs the plan over its row panel.
    #: ``make_train_step(mesh=)`` takes a ``LogicalMesh`` only: its loss
    #: already runs on the rank's rows.  None keeps local planning.
    fusion_layout: Optional[object] = None
    #: whole-plan staged execution of the fused loss (False: per-operator
    #: dispatch — the debug path; see repro_torch.core.codegen.CompiledPlan)
    fusion_staged: bool = True
    opt: adamw.OptConfig = adamw.OptConfig()


@fused
def _lse(L):
    m = L.rowmaxs()
    return ir.log(ir.exp(L - m).rowsums()) + m


#: the compiled fused LSE operators, one per (shape, mode, context,
#: device, layout, staged)
_LSE_OPS: dict = {}


def _fused_lse(logits2d: torch.Tensor, mode: str, layout=None,
               staged: bool = True) -> torch.Tensor:
    """log-sum-exp rows (``(rows, 1)``) through the fusion planner (Row
    template: rowmax → sub → exp → rowsums → log → add), staged
    explicitly: trace → plan → compile once per (shape, mode, layout,
    staged) under the current context's kernel policy on ``logits2d``'s
    device, then reuse the Compiled operator — whole-plan staged by
    default (``staged=False`` keeps per-operator dispatch for debugging).
    Differentiable: the backward pass runs the planned gradient DAG, under
    the same layout."""
    ctx = current_context()
    key = (tuple(logits2d.shape), mode, ctx.key(), str(logits2d.device),
           layout_signature(layout), staged)
    op = _LSE_OPS.get(key)
    if op is None:
        op = _lse.trace(logits2d).plan(mode=mode, layout=layout).compile(
            staged=staged, device=str(logits2d.device))
        _LSE_OPS[key] = op
    return op(logits2d)


def _ce(logits, targets, tc: TrainConfig):
    if tc.fusion == "off":
        return lm_loss(logits, targets)
    V = logits.shape[-1]
    flat = logits.reshape(-1, V).float()
    lse = _fused_lse(flat, tc.fusion, layout=tc.fusion_layout,
                     staged=tc.fusion_staged)
    tgt = torch.gather(flat, 1, targets.reshape(-1, 1).long())
    return torch.mean(lse - tgt)


def make_loss_fn(model: LM, cfg: ModelConfig, tc: TrainConfig):
    """``loss_fn(params, batch) -> (loss + aux weight · MoE aux, ce)`` over
    a dict of parameters; the batch's arrays are moved to the model's
    device.  A model placed on a mesh takes no ``fusion_layout`` but a
    ``LogicalMesh``: its loss already runs on the rank's rows, which a
    mesh of ranks would split again."""
    from repro_torch.dist import LogicalMesh
    lay = tc.fusion_layout
    if model.shard is not None and lay is not None and not isinstance(
            lay.mesh if isinstance(lay, FusionLayout) else lay, LogicalMesh):
        raise ValueError(
            "a sharded step runs the fused loss on the rank's rows: its "
            "TrainConfig.fusion_layout may only be a LogicalMesh, which "
            "prices the plan")

    def loss_fn(params, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        prefix = batch.get("patches")
        logits, aux = functional_call(model, params, (batch["tokens"],),
                                      {"prefix_emb": prefix})
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]
        targets = batch["targets"]
        if cfg.n_codebooks > 1:
            ce = torch.mean(torch.stack(
                [_ce(logits[..., c, :], targets[..., c], tc)
                 for c in range(cfg.n_codebooks)]))
        else:
            ce = _ce(logits, targets, tc)
        return ce + tc.moe_aux_weight * aux, ce
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, ce), grads) of ``loss_fn`` at ``params`` (a dict of
    tensors), every gradient in its parameter's dtype (zeros where the
    loss does not reach a parameter)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    total, ce = loss_fn(leaves, batch)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    return (total.detach(), ce.detach()), grads


def make_train_step(model: LM, cfg: ModelConfig, tc: TrainConfig,
                    mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the update is written into ``params`` and ``opt_state``,
    and those are returned.  A step whose loss is not finite leaves them
    as they were: the loop's skip keeps a step's inputs, which an update
    in place would have changed.

    With ``mesh`` the model must be placed on it (``LM.shard_``), and
    ``params`` / ``opt_state`` are the rank's blocks; ``batch`` is the
    global batch, of which each rank takes its data block of every
    microbatch (:func:`batch_block`).  ``metrics["loss"]`` is the global
    batch's, the same on every rank."""
    loss_fn = make_loss_fn(model, cfg, tc)
    if mesh is not None and (model.shard is None
                             or model.shard.mesh is not mesh):
        raise ValueError("make_train_step(mesh=): place the model on the "
                         "mesh first (LM.shard_)")

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(loss_fn, params, batch)
        return _sharded_value_and_grad(loss_fn, params,
                                       batch_block(mesh, cfg, batch,
                                                   model), mesh)

    def train_step(params, opt_state, batch):
        with spans.span("train.step"):
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        n_mb = tc.n_microbatches
        if n_mb > 1:
            mbs = {k: torch.as_tensor(v).reshape(
                (n_mb, v.shape[0] // n_mb) + tuple(v.shape[1:]))
                for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            for i in range(n_mb):
                (_, ce), g = grads_of(params,
                                      {k: v[i] for k, v in mbs.items()})
                for k in grads:
                    grads[k].add_(g[k].float())
                loss_sum = loss_sum + ce
                del g
            grads = {k: g / n_mb for k, g in grads.items()}
            loss = loss_sum / n_mb
        else:
            (_, loss), grads = grads_of(params, batch)
        gnorm = None
        if mesh is not None:
            grads = _reduce_grads(mesh, model.shard.specs, grads)
            gnorm = _global_norm(mesh, model.shard.specs, grads)
        if loss.device.type != "meta":
            with spans.span("sync"):
                finite = bool(torch.isfinite(loss))
            if not finite:
                return params, opt_state, {"loss": loss}
        with spans.span("optim.adamw"):
            new_params, new_opt, metrics = adamw.update(grads, opt_state,
                                                        params, tc.opt,
                                                        gnorm=gnorm)
        del grads
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# the sharded step's pieces
# ---------------------------------------------------------------------------

def batch_block(mesh, cfg: ModelConfig, batch: dict, model=None) -> dict:
    """Each array of a global batch cut to this rank's data block
    (``sh.batch_spec``: dim 0 over the row axes where they divide it,
    else the whole batch on every rank); records on ``model``'s layout
    whether the batch was split (``moe_a2a`` dispatches only then)."""
    from repro_torch.dist import sharding as sh
    out, split = {}, mesh.n == 1
    for k, v in batch.items():
        v = torch.as_tensor(v)
        spec = sh.batch_spec(mesh, cfg, v.shape[0], v.dim() - 1)
        split = split or bool(spec and spec[0])
        out[k] = sh.local_shard(mesh, spec, v)
    if model is not None and model.shard is not None:
        model.shard.batch_split = split
    return out


def _sharded_value_and_grad(loss_fn, params, batch, mesh):
    """((global loss, global ce), the rank's gradients) of one rank's
    block of a microbatch: its loss is its rows' mean, so the rank
    differentiates it over the number of data blocks (each rank's
    backward is its block's part of the global one; FSDP gathers
    reduce-scatter their leaves' gradients on the way), and the loss is
    the mean over the row group."""
    from repro_torch.dist.mesh import row_mean_fn
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    total, ce = loss_fn(leaves, batch)
    grads = torch.autograd.grad(total / mesh.n, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    both = row_mean_fn(mesh, torch.stack([total.detach().float(),
                                          ce.detach().float()]))
    return (both[0], both[1]), grads


def _missing_rows(mesh, spec: tuple) -> tuple:
    """The row axes a leaf of ``spec`` is replicated over."""
    from repro_torch.dist.sharding import entry_axes
    held = {a for e in spec for a in entry_axes(e)}
    return tuple(a for a in mesh.row_axes if a not in held)


def _reduce_grads(mesh, specs: dict, grads: dict) -> dict:
    """Every gradient summed over the row axes its leaf is replicated on
    (FSDP-sharded dims arrive reduce-scattered from the backward): the
    leaves of one set of such axes and one dtype flattened into one
    all-reduce, in key order."""
    groups: dict = {}
    for k in sorted(grads):
        miss = _missing_rows(mesh, specs[k])
        if miss and mesh.group_size(miss) > 1:
            groups.setdefault((miss, grads[k].dtype), []).append(k)
    out = dict(grads)
    for (miss, _dt), keys in groups.items():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        over = "row" if miss == mesh.row_axes else miss
        flat = mesh.all_reduce(flat, "psum", over=over)
        i = 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[i:i + n].view(grads[k].shape)
            i += n
    return out


def _global_norm(mesh, specs: dict, grads: dict) -> torch.Tensor:
    """The whole gradient's global norm from the ranks' blocks: each
    block's sum of squares divided by the number of ranks holding it, so
    that a replicated block counts once, summed over every rank."""
    from repro_torch.dist.sharding import entry_axes
    total = None
    for k in sorted(grads):
        held = 1
        for e in specs[k]:
            for a in entry_axes(e):
                held *= mesh.shape[a]
        sq = torch.sum(torch.square(grads[k].float())) * (held / mesh.world)
        total = sq if total is None else total + sq
    return torch.sqrt(mesh.all_reduce(total, "psum", over="all"))


# ---------------------------------------------------------------------------
# input specs (meta-tensor stand-ins, shared with the dry-run)
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The training batch's arrays as ``meta`` tensors of the reference's
    shapes and dtypes (its ``jax.ShapeDtypeStruct`` stand-ins): tokens and
    targets int32 (B, S) or (B, S, nc); llava's patches bf16 (B, 256, d),
    its tokens S − 256."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        S = S - N_PATCHES            # total context = patches + tokens
    tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    specs = {"tokens": torch.empty(tok_shape, dtype=torch.int32,
                                   device="meta"),
             "targets": torch.empty(tok_shape, dtype=torch.int32,
                                    device="meta")}
    if cfg.frontend == "vision":
        specs["patches"] = torch.empty((B, N_PATCHES, cfg.d_model),
                                       dtype=torch.bfloat16, device="meta")
    return specs


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                         dp: int) -> int:
    """Pick accumulation depth so per-microbatch activations fit the
    device while the microbatch still shards over the data axes."""
    total = cfg.total_params
    want = 8 if total > 1e11 else (4 if total > 2e10 else 2)
    return max(1, min(want, shape.global_batch // dp))


# ---------------------------------------------------------------------------
# the CLI: end-to-end training on one device
# ---------------------------------------------------------------------------

def preset_config(arch: str, preset: str) -> ModelConfig:
    """The CLI's configuration: the architecture's full one, its
    ``.reduced()`` one (``tiny``) or the reference's ``100m`` preset."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if preset == "tiny":
        cfg = cfg.reduced()
    elif preset == "100m":
        cfg = replace(cfg.reduced(), n_layers=8, d_model=512, n_heads=8,
                      n_kv_heads=min(8, max(1, cfg.n_kv_heads)),
                      head_dim=64, d_ff=2048 if cfg.d_ff else 0,
                      vocab=32_000)
    return cfg


class ShardedStore:
    """A :class:`~repro_torch.checkpoint.CheckpointStore` for a sharded
    run: a save joins every leaf's blocks (an all-gather over every rank,
    ``sh.join_shards``) and rank 0 writes the whole leaves in the
    one-device format; a restore reads them on every rank and cuts its
    blocks.  So a sharded run resumes into one rank, and one rank's
    checkpoint into a mesh."""

    def __init__(self, store, mesh, specs: dict, shapes: dict):
        self.store, self.mesh, self.specs = store, mesh, specs
        #: every parameter's whole shape
        self.shapes = shapes

    def latest_step(self):
        return self.store.latest_step()

    def _whole(self, tree: dict) -> dict:
        from repro_torch.dist import sharding as sh
        mesh = self.mesh

        def join(spec, t):
            if not any(sh.entry_axes(e) for e in spec):
                return t.detach().cpu()
            g = mesh.all_gather(t.detach().contiguous()[None], dim=0,
                                over="all").cpu()
            return sh.join_shards(mesh, spec, dict(enumerate(g.unbind(0))))
        return {"params": {k: join(self.specs[k], v)
                           for k, v in tree["params"].items()},
                "opt": {"m": {k: join(self.specs[k], v)
                              for k, v in tree["opt"]["m"].items()},
                        "v": {k: join(self.specs[k], v)
                              for k, v in tree["opt"]["v"].items()},
                        "count": tree["opt"]["count"].detach().cpu()}}

    def save(self, step: int, tree: dict, extra=None,
             blocking: bool = False) -> None:
        whole = self._whole(tree)
        if self.mesh.rank == 0:
            self.store.save(step, whole, extra=extra, blocking=True)

    def restore(self, like: dict) -> tuple:
        from repro_torch.dist import sharding as sh

        def empty(k, t):
            return torch.empty(self.shapes[k], dtype=t.dtype)
        whole_like = {
            "params": {k: empty(k, v) for k, v in like["params"].items()},
            "opt": {"m": {k: empty(k, v) for k, v in like["opt"]["m"].items()},
                    "v": {k: empty(k, v) for k, v in like["opt"]["v"].items()},
                    "count": like["opt"]["count"].detach().cpu()}}
        tree, extra = self.store.restore(whole_like)

        def cut(k, t, like_t):
            block = sh.local_shard(self.mesh, self.specs[k], t)
            return block.to(device=like_t.device, dtype=like_t.dtype,
                            copy=True).contiguous()
        out = {"params": {k: cut(k, v, like["params"][k])
                          for k, v in tree["params"].items()},
               "opt": {"m": {k: cut(k, v, like["opt"]["m"][k])
                             for k, v in tree["opt"]["m"].items()},
                       "v": {k: cut(k, v, like["opt"]["v"][k])
                             for k, v in tree["opt"]["v"].items()},
                       "count": tree["opt"]["count"].to(
                           like["opt"]["count"].device)}}
        return out, extra


def main(argv=None) -> None:
    import argparse
    import json

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data import DataConfig, ShardedLoader
    from repro_torch.train import LoopConfig, run_loop

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--preset", default="tiny",
                    choices=("tiny", "100m", "full"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fusion", default="off")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1,
                    help="train over this many rank processes (gloo), "
                         "started here through dist.launch.run_ranks")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis (data = ranks / model)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.ranks > 1 and args.rank is None:
        _spawn_ranks(args, argv)
        return
    mesh = None
    if args.rank is not None:
        mesh = _join_mesh(args)
    try:
        _train(args, mesh, CheckpointStore, DataConfig, ShardedLoader,
               LoopConfig, run_loop, json)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


#: the rank processes' deadline (``--ranks``), seconds
RANKS_TIMEOUT_S = 24 * 3600.0


def _spawn_ranks(args, argv) -> None:
    """Run the CLI in ``args.ranks`` rank processes of a gloo group
    (``file://`` rendezvous in a temporary directory) and print rank 0's
    output."""
    import sys

    from repro_torch.dist.launch import rank_env, run_ranks
    base = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory(prefix="repro_train_") as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        outs = run_ranks(
            lambda r: [sys.executable, "-m", "repro_torch.launch.train",
                       *base, "--rank", str(r), "--init", init],
            args.ranks, timeout=RANKS_TIMEOUT_S, env=rank_env())
    print(outs[0], end="", flush=True)


def _join_mesh(args):
    """Join the gloo group as rank ``args.rank`` and build the host
    mesh (every rank on the card ``rank % count``, or the CPU)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dev = args.device
    if dev.startswith("cuda"):
        dev = f"cuda:{args.rank % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(dev))
    dist.init_process_group("gloo", init_method=args.init,
                            world_size=args.ranks, rank=args.rank,
                            timeout=datetime.timedelta(seconds=300))
    return make_host_mesh(args.model_axis, device=dev)


def _train(args, mesh, CheckpointStore, DataConfig, ShardedLoader,
           LoopConfig, run_loop, json) -> None:
    cfg = preset_config(args.arch, args.preset)
    dev = args.device if mesh is None else str(mesh.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, device=dev).init(gen).requires_grad_(False)
    store = CheckpointStore(args.ckpt_dir)
    if mesh is not None:
        from repro_torch.dist import sharding as sh
        whole = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        specs = sh.param_specs(mesh, cfg, model.state_dict())
        model.shard_(mesh, specs)
        store = ShardedStore(store, mesh, specs, whole)
    params = dict(model.named_parameters())

    tc = TrainConfig(n_microbatches=1, fusion=args.fusion)
    opt_state = adamw.init(params, tc.opt)
    step_fn = make_train_step(model, cfg, tc, mesh=mesh)

    start = 0
    if args.resume and store.latest_step() is not None:
        tree, extra = store.restore({"params": params, "opt": opt_state})
        params, opt_state, start = tree["params"], tree["opt"], extra["step"]
        print(f"resumed from step {start}")

    loader = ShardedLoader(
        DataConfig(seq_len=args.seq, global_batch=args.batch,
                   vocab=cfg.vocab, n_codebooks=cfg.n_codebooks),
        start_step=start)
    cfg_loop = LoopConfig(total_steps=args.steps,
                          checkpoint_every=args.ckpt_every, log_every=5)

    def log(step, loss, dt, metrics):
        print(f"step {step:5d} loss {loss:.4f} "
              f"({dt * 1e3:.0f} ms/step)", flush=True)

    params, opt_state, st = run_loop(step_fn, params, opt_state, loader,
                                     cfg_loop, store=store,
                                     start_step=start, on_metrics=log)
    loader.close()
    where = "" if mesh is None else f" over {mesh.world} ranks {mesh.shape}"
    print(f"done: {st.step} steps{where}, final loss "
          f"{st.losses[-1] if st.losses else float('nan'):.4f}, "
          f"stragglers={len(st.straggler_events)}, "
          f"skipped={len(st.skipped_steps)}")
    # every step's loss at full precision, for a resumed run to be held to
    print("losses " + json.dumps({"first_step": start + 1,
                                  "losses": st.losses}), flush=True)


if __name__ == "__main__":
    main()
