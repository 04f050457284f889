"""Plain PyTorch training of the configuration's share of a decoder: the
same fit as ``scripts/lm_train.py`` (the pristine weights, ``fit_steps``
AdamW steps of ``n_microbatches`` micro-batches on the fit's tokens), in
fp32, written from the published architecture.  Imports nothing of the
program; it reads the weights by the port's state-dict names.

A layer: x + attn(rmsnorm(x)), then + moe(rmsnorm(.)); rmsnorm scales by
1 + scale (eps 1e-6).  Attention: GQA with rotate-half RoPE at
``rope_theta`` (the full layers with YaRN, ``rope_parameters``), causal
within ``sliding_window`` keys on the sliding layers, computed one query
block at a time and recomputed in the backward.  The expert layer: a
softmax router over all ``router_experts``, the top ``num_experts_per_tok``
renormalised, the held experts' SwiGLU (``expert_first`` onwards) on the
tokens routed to them, weighted; the other experts add nothing.  Loss:
the mean cross-entropy over the vocabulary slice plus 0.01 times the
router's load-balance loss (experts · Σ fraction routed · mean
probability, summed over layers).  AdamW as the port's defaults state it
(lr 3e-4 with 100 warm-up steps, betas 0.9 / 0.95, eps 1e-8, weight decay
0.1, the gradient clipped to norm 1).

``mm`` computes every product, forward and backward (fp32, TF32 for the
control, or a planted fault); gradients are taken under
``torch.enable_grad()``, since the comparison calls ``fit`` under
``torch.no_grad()``.  Each layer is recomputed in the backward
(``torch.utils.checkpoint``) and attention keeps K and V unexpanded, so
that the reference fits on the card beside the port's state (the
calibration holds both).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

LEAVES = ("layers.0.inner.wq", "layers.3.inner.wk", "layers.3.inner.wo",
          "layers.1.mlp.router", "layers.2.mlp.w1", "layers.0.ln1.scale",
          "final_norm.scale")
AUX_WEIGHT = 0.01
QBLOCK = 1024
OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "wd": 0.1,
       "clip": 1.0, "warmup": 100, "decay": 10_000, "min_ratio": 0.1}


def _product(mm):
    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return mm(a, b)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            return mm(g, b.transpose(-1, -2)), mm(a.transpose(-1, -2), g)
    return Product.apply


def _attention(mm, window: int, scale: float):
    """Causal attention over one sequence's heads (H, S, hd), a query
    block at a time; the backward recomputes each block's softmax."""

    def blocks(S, device):
        for i0 in range(0, S, QBLOCK):
            i1 = min(i0 + QBLOCK, S)
            j0 = max(0, i0 - window + 1) if window else 0
            q = torch.arange(i0, i1, device=device)[:, None]
            k = torch.arange(j0, i1, device=device)[None, :]
            keep = k <= q
            if window:
                keep &= k > q - window
            yield i0, i1, j0, keep

    def probs(q, k, keep):
        s = mm(q, k.transpose(-1, -2)) * scale
        s = torch.where(keep, s, -math.inf)
        return torch.softmax(s, dim=-1)

    def heads(t, rep):
        return torch.repeat_interleave(t, rep, dim=0)

    class Attn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            rep = q.shape[0] // k.shape[0]
            out = torch.empty_like(q)
            for i0, i1, j0, keep in blocks(q.shape[1], q.device):
                p = probs(q[:, i0:i1], heads(k[:, j0:i1], rep), keep)
                out[:, i0:i1] = mm(p, heads(v[:, j0:i1], rep))
            ctx.save_for_backward(q, k, v, out)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out = ctx.saved_tensors
            rep = q.shape[0] // k.shape[0]
            H, S, hd = q.shape
            dq = torch.zeros_like(q)
            dk, dv = (torch.zeros((H, S, hd), device=q.device)
                      for _ in "kv")
            delta = torch.sum(do * out, dim=-1, keepdim=True)
            for i0, i1, j0, keep in blocks(S, q.device):
                kb, vb = heads(k[:, j0:i1], rep), heads(v[:, j0:i1], rep)
                p = probs(q[:, i0:i1], kb, keep)
                dob = do[:, i0:i1]
                dv[:, j0:i1] += mm(p.transpose(-1, -2), dob)
                dp = mm(dob, vb.transpose(-1, -2))
                ds = p * (dp - delta[:, i0:i1]) * scale
                dq[:, i0:i1] = mm(ds, kb)
                dk[:, j0:i1] += mm(ds.transpose(-1, -2), q[:, i0:i1])
            # each KV head's gradient: the sum over its query heads
            fold = lambda t: t.reshape(-1, rep, S, hd).sum(1)  # noqa: E731
            return dq, fold(dk), fold(dv)
    return Attn.apply


def _rope(hd: int, S: int, theta: float, yarn, device):
    half = hd // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    inv = theta ** (-i / half)
    scale = 1.0
    if yarn is not None:
        factor, orig = yarn["factor"], yarn["original_max_position_embeddings"]

        def dim_of(turns):
            return hd * math.log(orig / (turns * 2 * math.pi)) \
                / (2 * math.log(theta))
        low = max(math.floor(dim_of(yarn["beta_fast"])), 0)
        high = min(math.ceil(dim_of(yarn["beta_slow"])), hd - 1)
        ramp = torch.clamp((i - low) / (high - low), 0.0, 1.0)
        inv = inv * (1 - ramp) + inv / factor * ramp
        scale = yarn["attention_factor"]
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def _rotate(x, cos, sin):
    """x (B, S, heads, hd)."""
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rms(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) \
        * (1.0 + scale)


def loss(W: dict, tokens, targets, cfg: dict, mm):
    """(cross-entropy, load-balance loss) of one micro-batch."""
    x = W["embed"][tokens.reshape(-1)]                       # (T, d)
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(cfg["layer_types"]):
        x, a = checkpoint(_layer, W, x, i, kind, tokens.shape, cfg, mm,
                          use_reentrant=False)
        aux = aux + a
    logits = _product(mm)(_rms(x, W["final_norm.scale"]), W["head"])
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, targets.reshape(-1, 1))[:, 0]
    return torch.mean(lse - tgt), aux


def _layer(W: dict, x, i: int, kind: str, shape, cfg: dict, mm):
    """Layer ``i`` of kind ``kind`` over x (B·S, d): (x, its load-balance
    loss)."""
    P = _product(mm)
    B, S = shape
    hd = cfg["head_dim"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    e0, held = cfg["expert_first"], cfg["num_experts"]
    L = lambda n: W[f"layers.{i}.{n}"]                        # noqa: E731
    rp = cfg["rope_parameters"][kind]
    cos, sin = _rope(hd, S, rp["rope_theta"],
                     rp if rp["rope_type"] == "yarn" else None, x.device)
    h = _rms(x, L("ln1.scale"))
    q = _rotate(P(h, L("inner.wq")).reshape(B, S, H, hd), cos, sin)
    kk = _rotate(P(h, L("inner.wk")).reshape(B, S, KV, hd), cos, sin)
    v = P(h, L("inner.wv")).reshape(B, S, KV, hd)
    attn = _attention(mm, 0 if kind == "full_attention"
                      else cfg["sliding_window"], hd ** -0.5)
    outs = [attn(q[b].transpose(0, 1), kk[b].transpose(0, 1),
                 v[b].transpose(0, 1)).transpose(0, 1).reshape(S, H * hd)
            for b in range(B)]
    x = x + P(torch.cat(outs), L("inner.wo"))
    h = _rms(x, L("ln2.scale"))
    probs = torch.softmax(P(h, L("mlp.router")), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    chosen = torch.zeros_like(probs).scatter(1, topi, 1.0)
    aux = E * torch.sum(torch.mean(chosen, 0) * torch.mean(probs, 0))
    y = torch.zeros_like(h)
    for j in range(held):
        tok, slot = torch.nonzero(topi == e0 + j, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        a = torch.nn.functional.silu(P(xe, L("mlp.w1")[j])) \
            * P(xe, L("mlp.w3")[j])
        y = y.index_add(0, tok, P(a, L("mlp.w2")[j])
                        * topv[tok, slot][:, None])
    return x + y, aux


def _lr(count: int) -> float:
    warm = min(count / OPT["warmup"], 1.0)
    t = min(max((count - OPT["warmup"]) / (OPT["decay"] - OPT["warmup"]),
                0.0), 1.0)
    cos = OPT["min_ratio"] + (1 - OPT["min_ratio"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return OPT["lr"] * warm * cos


def fit(ops: dict, fin: dict, cfg: dict, mm):
    start = ops["weights"]
    W = {n: w.clone() for n, w in start.items()}
    m = {n: torch.zeros_like(w) for n, w in W.items()}
    v = {n: torch.zeros_like(w) for n, w in W.items()}
    losses = []
    n_mb, rows = cfg["n_microbatches"], cfg["micro_batch"]
    for count, toks in enumerate(fin["tokens"], start=1):
        grads = {n: torch.zeros_like(w) for n, w in W.items()}
        ce_sum = 0.0
        for i in range(n_mb):
            mb = toks[i * rows:(i + 1) * rows]
            with torch.enable_grad():
                leaves = {n: w.detach().requires_grad_(True)
                          for n, w in W.items()}
                ce, aux = loss(leaves, mb[:, :-1], mb[:, 1:], cfg, mm)
                got = torch.autograd.grad(ce + AUX_WEIGHT * aux,
                                          list(leaves.values()),
                                          allow_unused=True)
            for (n, _w), g in zip(leaves.items(), got):
                if g is not None:
                    grads[n] += g
            ce_sum += float(ce)
        losses.append(ce_sum / n_mb)
        norm = math.sqrt(sum(float(torch.sum((g / n_mb) ** 2))
                             for g in grads.values()))
        clip = min(OPT["clip"] / (norm + 1e-9), 1.0)
        lr = _lr(count)
        bc1 = 1 - OPT["b1"] ** count
        bc2 = 1 - OPT["b2"] ** count
        for n in W:
            g = grads[n] / n_mb * clip
            m[n] = OPT["b1"] * m[n] + (1 - OPT["b1"]) * g
            v[n] = OPT["b2"] * v[n] + (1 - OPT["b2"]) * g * g
            step = m[n] / bc1 / (torch.sqrt(v[n] / bc2) + OPT["eps"])
            W[n] = W[n] - lr * (step + OPT["wd"] * W[n])
    return {"change": torch.cat([(W[n] - start[n]).reshape(-1)
                                 for n in LEAVES])}, losses
