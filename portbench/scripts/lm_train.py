"""LM training fits: the port's ``launch.train.make_train_step`` over one
chip's share of a model (its layers, experts and vocabulary slice, as the
configuration's file states), from weights drawn from the seed.

- The draw: every weight on the card from the run's seed
  (``LM.init``), kept as the pristine copy that every fit starts from.
- A fit: the weights restored from that copy and AdamW's state zeroed,
  then ``fit_steps`` steps, each of ``n_microbatches`` micro-batches of
  ``micro_batch`` packed sequences of ``seq_len`` tokens; it returns the
  change of a fixed few leaves (:data:`LEAVES`), flattened into one
  vector, and each step's loss.  One vector, since a first AdamW step is
  lr · sign(g): the change of a small leaf (a norm's 2,304 scales, a
  router) moves by a whole 2 / sqrt(n) of its norm where one near-zero
  gradient element's sign differs in the last bit.
- A fit's input: a batch seed drawn from the window's generator and the
  tokens drawn from it on the card, so that the reference trains on the
  same batch: Zipf (exponent ``zipf_exponent``) over the vocabulary
  slice, one ranking of the ids for all the sequences of a micro-batch,
  so that every micro-batch the experts take has the corpus's global
  skew (its first id a tenth of the tokens).  The ranking is drawn anew
  for each micro-batch: the weights are random, so the held experts'
  load follows where the seed's router sends the few heaviest ids, and
  one ranking for the whole run would fix that load, and the step's
  time, by the seed (0.65-1.07x the balanced load over the four
  layers on five seeds, a count on the CPU).  Drawn anew, the
  window's twenty micro-batches average the router's response.
"""

from __future__ import annotations

import torch

from portbench import lmwork

#: the leaves a fit returns the change of: a window and the full layer's
#: projections, a router, the held experts' up-projections, two norms
LEAVES = ("layers.0.inner.wq", "layers.3.inner.wk", "layers.3.inner.wo",
          "layers.1.mlp.router", "layers.2.mlp.w1", "layers.0.ln1.scale",
          "final_norm.scale")


def model_config(cfg: dict):
    """The port's configuration of the architecture, cut to this chip's
    share as the file states; raises where a width differs from it."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    full = get_config(cfg["port_arch"])
    widths = {"d_model": cfg["hidden_size"], "n_heads":
              cfg["num_attention_heads"], "n_kv_heads":
              cfg["num_key_value_heads"], "hd": cfg["head_dim"],
              "d_ff": cfg["moe_intermediate_size"], "n_experts":
              cfg["router_experts"], "top_k": cfg["num_experts_per_tok"],
              "sliding_window": cfg["sliding_window"]}
    for k, v in widths.items():
        if getattr(full, k) != v:
            raise ValueError(f"{cfg['port_arch']} {k} {getattr(full, k)} "
                             f"!= the configuration's {v}")
    return replace(full, n_layers=cfg["num_hidden_layers"],
                   vocab=cfg["vocab_size"], experts_held=cfg["num_experts"],
                   expert_first=cfg["expert_first"])


def draw(cfg: dict, seed: int, device) -> dict:
    from repro_torch.models import LM
    mc = model_config(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = LM(mc, device=device).init(gen).requires_grad_(False)
    return {"weights": {k: v.detach() for k, v in
                        model.state_dict().items()}}


def batch(cfg: dict, seed: int, device) -> torch.Tensor:
    """(fit_steps, n_microbatches · micro_batch, seq_len + 1) token ids
    from ``seed``: tokens are [..., :-1], targets [..., 1:]; ranks drawn
    Zipf, mapped to ids by one permutation a micro-batch (the step's
    rows split in order, as ``make_train_step`` splits them)."""
    V = cfg["vocab_size"]
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.arange(1, V + 1, dtype=torch.float64,
                     device=device) ** -cfg["zipf_exponent"]
    groups = cfg["fit_steps"] * cfg["n_microbatches"]
    per = cfg["micro_batch"] * (cfg["seq_len"] + 1)
    ranks = torch.multinomial(p.float(), groups * per, replacement=True,
                              generator=g)
    order = torch.argsort(torch.rand((groups, V), generator=g,
                                     device=device), dim=1)
    ids = torch.gather(order, 1, ranks.reshape(groups, per))
    return ids.reshape(cfg["fit_steps"], -1, cfg["seq_len"] + 1)


def fit_input(ops: dict, cfg: dict, rng) -> dict:
    seed = int(rng.integers(0, 2 ** 62))
    device = next(iter(ops["weights"].values())).device
    return {"batch_seed": seed, "tokens": batch(cfg, seed, device)}


def prepare(ops: dict, cfg: dict) -> dict:
    """The model (its own parameters), the train step and AdamW's state
    on the card; the pristine weights are the draw's."""
    from repro_torch.launch.train import TrainConfig, make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import adamw
    mc = model_config(cfg)
    device = next(iter(ops["weights"].values())).device
    model = LM(mc, device=device).requires_grad_(False)
    model.load_state_dict(ops["weights"])
    params = dict(model.named_parameters())
    tc = TrainConfig(n_microbatches=cfg["n_microbatches"], fusion="gen")
    return {"model": model, "params": params,
            "opt": adamw.init(params, tc.opt),
            "step": make_train_step(model, mc, tc),
            "pristine": ops["weights"]}


def port_fit(port_ops: dict, fin: dict, cfg: dict):
    from repro_torch import spans
    params, opt, pristine = (port_ops["params"], port_ops["opt"],
                             port_ops["pristine"])
    with spans.span("lm_train.run"):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(pristine[k])
            for moment in (opt["m"], opt["v"]):
                for t in moment.values():
                    t.zero_()
            opt["count"].zero_()
        losses = []
        for toks in fin["tokens"]:
            params, opt, metrics = port_ops["step"](
                params, opt, {"tokens": toks[:, :-1],
                              "targets": toks[:, 1:]})
            losses.append(metrics["loss"])
        with spans.span("sync"):
            losses = [float(v) for v in losses]
        change = torch.cat([(params[k] - pristine[k]).reshape(-1)
                            for k in LEAVES])
    return {"change": change}, losses


def regions(cfg: dict, meta) -> list:
    from repro_torch.launch import train
    rows = cfg["micro_batch"] * cfg["seq_len"]
    return [(train._lse, (meta(rows, cfg["vocab_size"]),), True)]


def fit_work(cfg: dict, ops: dict) -> tuple[int, int]:
    return lmwork.fit_work(cfg)
