"""Shared model layers: norms, MLPs and their parameters, in PyTorch.

Parameters are dict-like (an ``nn.ParameterDict`` of the model, or a plain
dict of tensors) under the reference's names.  The rmsnorm chain is a
fusion site for the paper's planner: ``norm(..., fusion=mode)`` runs it as
one staged fused operator of :mod:`repro_torch.core` (on the card, the
generated Row kernel); the default path is plain torch.  ``constrain``
(:func:`repro_torch.dist.sharding.constrain`) marks the reference's
activation-sharding points: the identity outside ``activation_rules``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fused, fusion_mode, ir
from repro_torch.dist.sharding import constrain
from .sharded import enter, proj, row, weights


def norm(x: torch.Tensor, scale: torch.Tensor, kind: str = "rmsnorm",
         bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
         fusion: Optional[str] = None) -> torch.Tensor:
    """Row-template chain: per-row second moment (rmsnorm, scaled by
    ``1 + scale``) or mean and variance (layernorm, ``scale`` and
    ``bias``), in fp32, returned in ``x``'s dtype.

    ``fusion`` routes the rmsnorm chain through the paper's planner as a
    staged fused operator (mode string, e.g. ``"gen"``)."""
    xf = x.float()
    if kind == "rmsnorm" and fusion is not None:
        flat = xf.reshape(-1, x.shape[-1])
        out = _fused_rmsnorm(flat, scale.float().reshape(1, -1), eps,
                             fusion).reshape(xf.shape)
    elif kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * (1.0 + scale.float())
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            out = out + bias.float()
    return out.to(x.dtype)


@fused
def _rms(X, s, eps_s):
    ms = (X ** 2).rowmeans()
    return X * ir.sqrt(ms + eps_s).unary("recip") * (1.0 + s)


def _fused_rmsnorm(flat: torch.Tensor, scale_row: torch.Tensor, eps: float,
                   mode: str) -> torch.Tensor:
    """Staged fused rmsnorm over (rows, d): traced, planned and compiled
    once per (shape, mode, kernel policy, device) by the ``@fused``
    wrapper's memo, on ``flat``'s device under the current context's
    kernel policy; differentiable through the operator's planned
    backward."""
    eps_t = torch.full((1, 1), eps, dtype=torch.float32, device=flat.device)
    with fusion_mode(mode=mode, device=str(flat.device)):
        return _rms(flat, scale_row, eps_t)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(x: torch.Tensor, p, kind: str, sh=None) -> torch.Tensor:
    """Dense MLP; the activation chain is a Cell-template fusion site.
    Under a mesh (``sh``) ``w1`` / ``w3`` give the rank's block of the ff
    columns and ``w2``'s partial sums are reduced (:mod:`.sharded`)."""
    p = weights(p, sh)
    xe = enter(x, sh)

    def up(w):
        return proj(x, xe, p, w, sh)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = constrain(act(up("w1")) * up("w3"), "btf")
    elif kind == "gelu":
        h = constrain(_gelu(up("w1")), "btf")
    elif kind == "relu2":
        h = torch.clamp_min(up("w1"), 0.0)
        h = constrain(h * h, "btf")
    else:
        raise ValueError(kind)
    return row(h, p, "w2", sh, seq=True)


def normal(gen: Optional[torch.Generator], shape,
           scale: float) -> torch.Tensor:
    """Standard normal fp32 draws on the generator's device, times
    ``scale``; with no generator, a meta tensor of that shape (the shapes
    alone)."""
    if gen is None:
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale)


def fixed(gen: Optional[torch.Generator], shape, value) -> torch.Tensor:
    """A fixed initial value (fp32) of ``shape`` on the generator's device:
    a scalar, or a row broadcast over the leading axes; with no generator,
    a meta tensor of that shape.  Draws nothing from ``gen``."""
    if gen is None:
        return torch.empty(shape, device="meta")
    return torch.tensor(value, dtype=torch.float32,
                        device=gen.device).expand(shape).clone()


def mlp_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The MLP's weights drawn from ``gen`` (fp32, see :func:`normal`):
    w1 (d, f), w2 (f, d) and, for the gated kinds, w3 (d, f)."""
    d, f = cfg.d_model, cfg.d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"w1": normal(gen, (d, f), s_in), "w2": normal(gen, (f, d), s_out)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w3"] = normal(gen, (d, f), s_in)
    return p


def norm_params(cfg: ModelConfig, device="cpu") -> dict:
    """The norm's initial parameters (fp32): rmsnorm scale 0 (it scales by
    1 + scale); layernorm scale 1 and bias 0."""
    d = cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    return {"scale": torch.zeros((d,), device=device)}


def apply_norm(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    return norm(x, p["scale"], cfg.norm_type, p.get("bias"))
