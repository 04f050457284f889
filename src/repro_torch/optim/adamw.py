"""AdamW with an optional bf16 state and global-norm clipping.

The reference's arithmetic, in its order (``repro.optim.adamw``): the
gradient scaled by the clip factor, the moments in fp32, the bias-corrected
step plus weight decay, the parameter updated in fp32 and cast back.  The
update runs leaf by leaf, so that only one leaf's fp32 temporaries are
alive at a time: at minitron-4b's width the embedding alone is 786M
elements, 3.15 GB a fp32 copy.

``update`` writes the new parameters and moments into the given tensors
(the counterpart of the reference's donated buffers) and returns them; the
values are the bits the reference's arithmetic gives.  The state lives
where the parameters live: on a mesh (the sharded train step) each rank
holds and updates the moments of its blocks, as the reference shards the
state like the parameters (ZeRO-3 / FSDP).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.tree import leaves, map_tree


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"      # bf16 halves optimizer memory


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup + cosine decay (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params, cfg: OptConfig) -> dict:
    """Zero moments of each parameter's shape on its device (fp32, or bf16
    with ``state_dtype="bfloat16"``) and a step count of 0."""
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


@torch.no_grad()
def _update_leaf(p, g, m, v, scale, lr, bc1, bc2, cfg: OptConfig) -> None:
    """Writes one leaf's update into ``p``, ``m`` and ``v``; ``.float()``
    is the tensor itself where it is fp32 already."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.to(torch.float32, copy=True).mul_(scale)
    m32 = m.float().mul_(b1).add_(g32 * (1 - b1))
    v32 = v.float().mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
    del g32
    step = m32 / bc1
    step.div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
    p32 = p.float()
    step.add_(p32 * cfg.weight_decay)
    p32.sub_(step.mul_(lr))
    del step
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


@torch.no_grad()
def update(grads, state, params, cfg: OptConfig, gnorm=None):
    """Writes the update into ``params`` and ``state`` and returns
    (params, state, metrics).  ``gnorm``: the gradient's global norm where
    ``grads`` are one rank's blocks of it (default: theirs)."""
    count = state["count"].add_(1)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(count, cfg)
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        _update_leaf(p, g, m, v, scale, lr, bc1, bc2, cfg)
    return params, state, {"grad_norm": gnorm, "lr": lr}
