"""A plain fp32 PyTorch Mellum2 decoder (JetBrains/Mellum2-12B-A2.5B
config.json), written from the published description, for the CPU tests
of the port's ``mellum2-12b-a2.5b`` at small sizes: no kernel, no cache,
no block loop, dense masked attention and every expert over every token
(gated).  It imports nothing of the port: the configuration is read as
data, the weights by the port's state-dict names.

A layer: x + attn(rmsnorm(x)), then + moe(rmsnorm(.)).  rmsnorm scales by
1 + scale (the port's parameterisation of the published weight), eps
1e-6.  Attention: GQA, rotate-half RoPE at rope_theta; the layers before
the last of each ``local_global_period`` see ``sliding_window`` keys, the
last sees all with YaRN frequencies and cos / sin scaled by the attention
factor (Hugging Face's ``_compute_yarn_parameters``).  Experts: softmax
router over all ``n_experts``, top-k renormalised (``norm_topk_prob``),
SwiGLU experts ``expert_first`` .. + ``experts_held`` (all where 0); the
load-balance loss E · Σ fraction routed · mean probability.  Departures
from the published model (as the benchmark's configuration states): no
norm on q and k, no MTP head.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def yarn_inv_freq(hd: int, theta: float, yarn) -> tuple:
    """(inverse frequencies, cos / sin scale) as ``_compute_yarn_parameters``
    writes them: interpolation 1 / (factor · θ^(2i/d)), extrapolation
    1 / θ^(2i/d), blended by 1 − ramp between the corrected dims."""
    pos = theta ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    if not yarn:
        return 1.0 / pos, 1.0
    factor, original, beta_fast, beta_slow, mscale = yarn

    def corr(turns):
        return (hd * math.log(original / (turns * 2 * math.pi))) \
            / (2 * math.log(theta))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), hd - 1)
    ramp = torch.clamp((torch.arange(hd // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    extrapolation = 1 - ramp
    inv = (1.0 / (factor * pos)) * (1 - extrapolation) \
        + (1.0 / pos) * extrapolation
    return inv, mscale


def _rope(x, inv, scale):
    S, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv[None]
    cos = (torch.cos(ang) * scale)[None, :, None, :]
    sin = (torch.sin(ang) * scale)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rms(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) \
        * (1 + scale)


def attention(h, W, pre, cfg, window: int, yarn):
    B, S, _d = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    inv, scale = yarn_inv_freq(hd, cfg.rope_theta, yarn)
    q = _rope((h @ W[pre + "wq"]).reshape(B, S, H, hd), inv, scale)
    k = _rope((h @ W[pre + "wk"]).reshape(B, S, KV, hd), inv, scale)
    v = (h @ W[pre + "wv"]).reshape(B, S, KV, hd)
    k = torch.repeat_interleave(k, H // KV, dim=2)
    v = torch.repeat_interleave(v, H // KV, dim=2)
    return dense_attention(q, k, v, window).reshape(B, S, H * hd) \
        @ W[pre + "wo"]


def dense_attention(q, k, v, window: int):
    """q, k, v (B, S, H, hd): causal softmax attention within ``window``
    keys (0: all), the masked scores -inf."""
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    i = torch.arange(S)
    keep = i[None, :] <= i[:, None]
    if window:
        keep &= i[None, :] > i[:, None] - window
    p = torch.softmax(torch.where(keep, s, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def experts(h, W, pre, cfg):
    """(the held experts' gated output, the load-balance loss)."""
    T = h.shape[0] * h.shape[1]
    x = h.reshape(T, -1)
    probs = torch.softmax(x @ W[pre + "router"], dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, topi, topv)
    E = cfg.n_experts
    aux = E * torch.sum(torch.mean((gates > 0).float(), 0)
                        * torch.mean(probs, 0))
    e0 = cfg.expert_first
    held = cfg.experts_held or E
    y = torch.zeros_like(x)
    for j in range(held):
        a = F.silu(x @ W[pre + "w1"][j]) * (x @ W[pre + "w3"][j])
        y = y + gates[:, e0 + j:e0 + j + 1] * (a @ W[pre + "w2"][j])
    return y.reshape(h.shape), aux


def forward(W: dict, tokens: torch.Tensor, cfg):
    """(logits (B, S, V), load-balance loss summed over layers)."""
    x = W["embed"][tokens]
    aux = torch.zeros(())
    p = cfg.local_global_period or 1
    for i in range(cfg.n_layers):
        full = i % p == p - 1
        pre = f"layers.{i}."
        h = _rms(x, W[pre + "ln1.scale"])
        x = x + attention(h, W, pre + "inner.", cfg,
                          0 if full else cfg.sliding_window,
                          cfg.yarn if full else ())
        y, a = experts(_rms(x, W[pre + "ln2.scale"]), W, pre + "mlp.", cfg)
        x, aux = x + y, aux + a
    return _rms(x, W["final_norm.scale"]) @ W["head"], aux


def loss(W, tokens, targets, cfg, aux_weight: float = 0.01):
    """(mean cross-entropy + aux_weight · load-balance loss, cross-entropy)."""
    logits, aux = forward(W, tokens, cfg)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1))
    return ce + aux_weight * aux, ce


def adamw_step(W, grads, m, v, count: int, lr0=3e-4, b1=0.9, b2=0.95,
               eps=1e-8, wd=0.1, clip=1.0, warmup=100):
    """One AdamW step in place (the port's defaults: linear warm-up over
    ``warmup`` steps, the gradient clipped to norm ``clip``)."""
    norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    c = min(clip / (norm + 1e-9), 1.0)
    lr = lr0 * min(count / warmup, 1.0)
    for n in W:
        g = grads[n] * c
        m[n] = b1 * m[n] + (1 - b1) * g
        v[n] = b2 * v[n] + (1 - b2) * g * g
        step = (m[n] / (1 - b1 ** count)) \
            / (torch.sqrt(v[n] / (1 - b2 ** count)) + eps)
        W[n] = W[n] - lr * (step + wd * W[n])
