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

The CLI runs on one device.  The reference's parameter placement over a
host mesh (``sh.param_specs``, with its activation rules) and its
``train_batch_specs`` (``jax.ShapeDtypeStruct`` stand-ins) wait with the
dry-run tools (ROADMAP.md queue A item 7.4).
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import current_context, fused, ir
from repro_torch.models import LM, lm_loss
from repro_torch.optim import adamw


@dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    moe_aux_weight: float = 0.01
    fusion: str = "off"          # off | gen | fa | fnr  (planner arm)
    opt: adamw.OptConfig = adamw.OptConfig()


@fused
def _lse(L):
    m = L.rowmaxs()
    return ir.log(ir.exp(L - m).rowsums()) + m


#: the compiled fused LSE operators, one per (shape, mode, context,
#: device)
_LSE_OPS: dict = {}


def _fused_lse(logits2d: torch.Tensor, mode: str) -> torch.Tensor:
    """log-sum-exp rows (``(rows, 1)``) through the fusion planner (Row
    template: rowmax → sub → exp → rowsums → log → add), staged
    explicitly: trace → plan → compile once per (shape, mode) under the
    current context's kernel policy on ``logits2d``'s device, then reuse
    the Compiled operator.  Differentiable: the backward pass runs the
    planned gradient DAG.  The reference's ``layout`` and ``staged``
    options wait with the training placement (ROADMAP.md queue A item
    7.4)."""
    ctx = current_context()
    key = (tuple(logits2d.shape), mode, ctx.key(), str(logits2d.device))
    op = _LSE_OPS.get(key)
    if op is None:
        op = _lse.trace(logits2d).plan(mode=mode).compile(
            device=str(logits2d.device))
        _LSE_OPS[key] = op
    return op(logits2d)


def _ce(logits, targets, tc: TrainConfig):
    if tc.fusion == "off":
        return lm_loss(logits, targets)
    V = logits.shape[-1]
    flat = logits.reshape(-1, V).float()
    lse = _fused_lse(flat, tc.fusion)
    tgt = torch.gather(flat, 1, targets.reshape(-1, 1).long())
    return torch.mean(lse - tgt)


def make_loss_fn(model: LM, cfg: ModelConfig, tc: TrainConfig):
    """``loss_fn(params, batch) -> (loss + aux weight · MoE aux, ce)`` over
    a dict of parameters; the batch's arrays are moved to the model's
    device."""
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


def make_train_step(model: LM, cfg: ModelConfig, tc: TrainConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the update is written into ``params`` and ``opt_state``,
    and those are returned.  A step whose loss is not finite leaves them
    as they were: the loop's skip keeps a step's inputs, which an update
    in place would have changed."""
    loss_fn = make_loss_fn(model, cfg, tc)

    def train_step(params, opt_state, batch):
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
                (_, ce), g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mbs.items()})
                for k in grads:
                    grads[k].add_(g[k].float())
                loss_sum = loss_sum + ce
                del g
            grads = {k: g / n_mb for k, g in grads.items()}
            loss = loss_sum / n_mb
        else:
            (_, loss), grads = value_and_grad(loss_fn, params, batch)
        if not bool(torch.isfinite(loss)):
            return params, opt_state, {"loss": loss}
        new_params, new_opt, metrics = adamw.update(grads, opt_state,
                                                    params, tc.opt)
        del grads
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, metrics

    return train_step


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
    args = ap.parse_args(argv)

    cfg = preset_config(args.arch, args.preset)
    gen = torch.Generator(device=args.device).manual_seed(0)
    model = LM(cfg, device=args.device).init(gen).requires_grad_(False)
    params = dict(model.named_parameters())

    tc = TrainConfig(n_microbatches=1, fusion=args.fusion)
    opt_state = adamw.init(params, tc.opt)
    step_fn = make_train_step(model, cfg, tc)

    store = CheckpointStore(args.ckpt_dir)
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
    print(f"done: {st.step} steps, final loss "
          f"{st.losses[-1] if st.losses else float('nan'):.4f}, "
          f"stragglers={len(st.straggler_events)}, "
          f"skipped={len(st.skipped_steps)}")
    # every step's loss at full precision, for a resumed run to be held to
    print("losses " + json.dumps({"first_step": start + 1,
                                  "losses": st.losses}), flush=True)


if __name__ == "__main__":
    main()
