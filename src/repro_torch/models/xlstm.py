"""xLSTM (mLSTM) block — matrix-memory recurrent cell with exponential
gating and stabilizer state (arXiv:2405.04517), in PyTorch.

Prefill runs the cell as a Python loop over time on the device (the
reference's ``lax.scan``), in fp32 as the reference does; decode is the
same cell for one token.  State per head: C (hd×hd) matrix memory, n (hd)
normalizer, m (scalar) stabilizer.  Given a state, the loop starts from it
and writes the final state into its tensors in place (a serving slot's
state is a view of the engine's pool).

``F.softplus`` returns its input above 20 where JAX's is exact: log σ(f)
differs from the reference's by at most about 2e-9 there.

Under a mesh (``sh``, :mod:`.sharded`) a rank runs its block of heads
where ``wq`` / ``wk`` / ``wv`` are sharded on whole heads: ``up``'s
blocks are gathered (q, k and v read every channel of u), the replicated
``wif`` gives every head's gates, of which the rank takes its own, the
cell runs on its heads' state, and ``down``'s partial sums are reduced.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import normal
from .mamba import _recorded, _write_state
from .sharded import row, weights


def xlstm_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The projections drawn from ``gen`` (fp32, N(0, 1/fan_in))."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    s, si = d ** -0.5, di ** -0.5
    H = cfg.n_heads
    return {
        "up": normal(gen, (d, 2 * di), s),
        "wq": normal(gen, (di, di), si),
        "wk": normal(gen, (di, di), si),
        "wv": normal(gen, (di, di), si),
        "wif": normal(gen, (di, 2 * H), si),
        "down": normal(gen, (di, d), si),
    }


def _cell_step(state, inputs):
    """One step.  state: (C (B,H,hd,hd), n (B,H,hd), m (B,H)), fp32, C
    updated in place where autograd records nothing (serving) and out of
    place where it does (training), with the same bits; inputs: q, k, v (B,H,hd), the input
    gate's pre-activation and log σ(forget pre-activation) (B,H), both
    computed for every step before the loop.  Returns ((C, n, m), h
    (B,H,hd))."""
    C, n, m = state
    q, k, v, ipre, logf = inputs
    m_new = torch.maximum(logf + m, ipre)
    i_g = torch.exp(ipre - m_new)[..., None]
    f_g = torch.exp(logf + m - m_new)[..., None]
    upd = i_g[..., None] * (v[..., :, None] * k[..., None, :])
    if _recorded(C, f_g, upd):
        C = C * f_g[..., None] + upd
    else:
        C.mul_(f_g[..., None]).add_(upd)
    n = f_g * n + i_g * k
    h_num = (C @ q[..., None])[..., 0]
    h_den = torch.maximum(torch.abs(torch.sum(n * q, dim=-1)),
                          torch.exp(-m_new))[..., None]
    return (C, n, m_new), h_num / h_den


def mlstm(x: torch.Tensor, p, cfg: ModelConfig, *,
          state: Optional[dict] = None, sh=None):
    """x: (B, L, d) -> (B, L, d).  Returns (out, state): with a state,
    the loop starts from it and the final state is written into it."""
    B, L, d = x.shape
    di = cfg.ssm_expand * d
    H = cfg.n_heads
    hd = di // H
    p = weights(p, sh)
    xz = x @ p["up"]
    if sh is not None:
        xz = sh.full(xz, "up")
    u, z = torch.chunk(xz, 2, dim=-1)                     # (B, L, di)
    q, k, v = u @ p["wq"], u @ p["wk"], u @ p["wv"]
    if sh is not None:
        q, h0 = sh.heads(q, "wq", H)
        k, _ = sh.heads(k, "wk", H)
        v, _ = sh.heads(v, "wv", H)
    q = (q.reshape(B, L, -1, hd) * hd ** -0.5).float()
    k = (k.reshape(B, L, -1, hd) * hd ** -0.5).float()
    v = v.reshape(B, L, -1, hd).float()
    gif = (u @ p["wif"]).float()                          # (B, L, 2H)
    ipre, logf = gif[..., :H], -F.softplus(-gif[..., H:])  # log σ(f)
    H = q.shape[2]                                        # this rank's
    if sh is not None and H != cfg.n_heads:
        ipre, logf = ipre[..., h0:h0 + H], logf[..., h0:h0 + H]
        z = z[..., h0 * hd:(h0 + H) * hd]

    if state is None:
        st = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                          device=x.device),
              torch.zeros((B, H, hd), dtype=torch.float32, device=x.device),
              torch.zeros((B, H), dtype=torch.float32, device=x.device))
    else:
        st = (state["C"].clone(), state["n"], state["m"])
    hs = []
    for t in range(L):
        st, h = _cell_step(st, (q[:, t], k[:, t], v[:, t], ipre[:, t],
                                logf[:, t]))
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, L, H * hd).to(x.dtype)
    out = row(h * F.silu(z), p, "down", sh)
    if state is not None:
        _write_state(state, dict(zip(("C", "n", "m"), st)))
    return out, state


def mlstm_decode(x: torch.Tensor, p, cfg: ModelConfig, state: dict,
                 sh=None):
    return mlstm(x, p, cfg, state=state, sh=sh)


def init_xlstm_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    di = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    hd = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.zeros((batch, H), **f32)}
