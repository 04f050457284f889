"""Mamba selective-SSM layer (Jamba's recurrent block), in PyTorch.

Prefill runs the selective scan as a Python loop over time on the
device (the reference's ``lax.scan``; the loop is one ``addcmul`` a step,
in place where autograd records nothing, out of place where it does, so
that training differentiates through it); decode is a single O(1) state update.  Given a
state, both write the final state into its tensors in place (a serving
slot's state is a view of the engine's pool) and return it.

Two quirks of the reference are kept for parity (ROADMAP.md queue C):
``dt`` takes only ``dt_bias[-1]``, and the prefill's causal conv starts
from zeros whatever ``state["conv"]`` holds.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import fixed, normal


def mamba_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The projections drawn from ``gen`` (fp32, see
    :func:`~repro_torch.models.layers.normal`; ``conv_w`` at the
    reference's scale 0.1) and the reference's fixed values: ``conv_b``
    and ``dt_bias`` 0, ``A_log`` log(1..N) per channel, ``D`` 1."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N, K = cfg.ssm_state, cfg.ssm_conv
    s, si = d ** -0.5, di ** -0.5
    return {
        "in_proj": normal(gen, (d, 2 * di), s),
        "conv_w": normal(gen, (K, di), 0.1),
        "conv_b": fixed(gen, (di,), 0.0),
        "x_proj": normal(gen, (di, 2 * N + 1), si),
        "dt_bias": fixed(gen, (di,), 0.0),
        "A_log": fixed(gen, (di, N), [math.log(i) for i in range(1, N + 1)]),
        "D": fixed(gen, (di,), 1.0),
        "out_proj": normal(gen, (di, d), si),
    }


def _write_state(state: dict, new: dict) -> None:
    """The layer's new recurrent state into ``state``'s tensors, in
    place."""
    for k, v in new.items():
        state[k].copy_(v)


def _ssm_inputs(u: torch.Tensor, p, N: int):
    """B, C (fp32) and the step size dt (fp32, from ``dt_bias[-1]`` only,
    as the reference) of the conv output u (..., di)."""
    xdbc = u @ p["x_proj"]                                # (..., 2N+1)
    B_ = xdbc[..., :N].float()
    C_ = xdbc[..., N:2 * N].float()
    dt = F.softplus(xdbc[..., 2 * N:] + p["dt_bias"][-1]).float()
    return B_, C_, dt


def _recorded(*ts) -> bool:
    """Whether autograd records an op on these tensors (then a state must
    not be updated in place)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _selective_scan(u, dt, B_, C_, A, h0):
    """u, dt: (B, L, di); B_, C_: (B, L, N); A: (di, N); h0: (B, di, N),
    all fp32.  Returns (y (B, L, di), hL).  h_t = h_{t-1} · dA_t + dBx_t.
    Where autograd records nothing (serving, under ``no_grad``) each step
    overwrites its dBx with its state, so the states need no buffer of
    their own; where it records (training) the states are new tensors,
    stacked, with the same bits."""
    dA = torch.exp(dt[..., None] * A)                     # (B, L, di, N)
    hs = dt[..., None] * B_[:, :, None, :] * u[..., None]
    h = h0
    if _recorded(hs, dA, h0):
        states = []
        for t in range(u.shape[1]):
            h = torch.addcmul(hs[:, t], h, dA[:, t])
            states.append(h)
        hs = torch.stack(states, dim=1)
    else:
        for t in range(u.shape[1]):
            h = hs[:, t].addcmul_(h, dA[:, t])
    del dA
    y = torch.einsum("bldn,bln->bld", hs, C_)
    return y, h


def mamba(x: torch.Tensor, p, cfg: ModelConfig, *,
          state: Optional[dict] = None):
    """Full-sequence Mamba.  x: (B, L, d).  Returns (out, state): with a
    state, the scan starts from ``state["h"]`` and the final state is
    written into it."""
    B, L, d = x.shape
    di = cfg.ssm_expand * d
    N, K = cfg.ssm_state, cfg.ssm_conv
    xz = x @ p["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                     # (B, L, di)
    # causal depthwise conv, from zeros
    pad = torch.zeros((B, K - 1, di), dtype=u.dtype, device=u.device)
    uc = torch.cat([pad, u], dim=1)
    u = sum(uc[:, i:i + L] * p["conv_w"][i] for i in range(K)) + p["conv_b"]
    u = F.silu(u)
    B_, C_, dt = _ssm_inputs(u, p, N)
    dt = dt.expand(B, L, di)
    A = -torch.exp(p["A_log"].float())
    h0 = (state["h"] if state is not None else
          torch.zeros((B, di, N), dtype=torch.float32, device=x.device))
    y, hL = _selective_scan(u.float(), dt, B_, C_, A, h0)
    y = y.to(x.dtype) + u * p["D"]
    out = (y * F.silu(z)) @ p["out_proj"]
    if state is not None:
        # conv state: the last K-1 raw inputs (uc = [pad(K-1), u_raw(L)])
        _write_state(state, {"h": hL, "conv": uc[:, L:]})
    return out, state


def mamba_decode(x: torch.Tensor, p, cfg: ModelConfig, state: dict):
    """One-token Mamba step.  x: (B, 1, d); state: {h (B, di, N) fp32,
    conv (B, K-1, di)}, updated in place.  Returns (out (B, 1, d),
    state)."""
    B, _, d = x.shape
    di = cfg.ssm_expand * d
    N, K = cfg.ssm_state, cfg.ssm_conv
    xz = x[:, 0] @ p["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                     # (B, di)
    conv_buf = torch.cat([state["conv"], u[:, None]], dim=1)
    u = sum(conv_buf[:, i] * p["conv_w"][i] for i in range(K)) + p["conv_b"]
    u = F.silu(u)
    B_, C_, dt = _ssm_inputs(u, p, N)
    dt = dt.expand(B, di)
    A = -torch.exp(p["A_log"].float())
    h = state["h"] * torch.exp(dt[..., None] * A) \
        + dt[..., None] * B_[:, None, :] * u.float()[..., None]
    y = torch.einsum("bdn,bn->bd", h, C_).to(x.dtype) + u * p["D"]
    out = (y * F.silu(z)) @ p["out_proj"]
    _write_state(state, {"h": h, "conv": conv_buf[:, 1:]})
    return out[:, None], state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device="cpu") -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                                device=device)}
