"""GQA attention with RoPE, causal / sliding-window masking and a KV cache.

Layouts are the reference's: activations (B, S, H, hd), caches
(B, max_len, KV, hd).  Scores are computed from fp32 operands, as the
reference's ``preferred_element_type=float32`` asks, so bf16 scores are
not rounded to bf16.  K/V are written into the cache tensors in place
(the reference returns updated copies): a serving slot's cache is a view
of the engine's, so nothing is copied back.

Under a mesh (``sh``, :mod:`.sharded`) a rank runs its block of query
heads and of KV heads where ``wq`` / ``wk`` / ``wv`` are sharded on whole
heads (all heads, gathered, where a block would split one), maps each
local query head to its KV head (local or replicated), writes its block
of the cache's heads, and reduces ``wo``'s partial sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from .layers import normal
from .sharded import row, weights


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The attention weights drawn from ``gen`` (fp32, see
    :func:`~repro_torch.models.layers.normal`)."""
    d, hd = cfg.d_model, cfg.hd
    s = d ** -0.5
    return {"wq": normal(gen, (d, cfg.n_heads * hd), s),
            "wk": normal(gen, (d, cfg.n_kv_heads * hd), s),
            "wv": normal(gen, (d, cfg.n_kv_heads * hd), s),
            "wo": normal(gen, (cfg.n_heads * hd, d),
                         (cfg.n_heads * hd) ** -0.5)}


def _mask(q_pos, k_pos, window: int):
    """causal (+ sliding window) mask: (B, Sq, Sk) bool keep."""
    keep = k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        keep &= k_pos[:, None, :] > q_pos[:, :, None] - window
    return keep


def _write(leaf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``leaf[:, start:start + S] = new`` in place.  Where the reference's
    ``dynamic_update_slice`` would clamp the start (and so write to other
    positions than asked), this raises IndexError."""
    S, L = new.shape[1], leaf.shape[1]
    if start < 0 or start + S > L:
        raise IndexError(f"cache write of {S} positions at {start} past "
                         f"the cache's {L}")
    leaf[:, start:start + S] = new


def _scores(q: torch.Tensor, k: torch.Tensor, spec: str,
            scale: float) -> torch.Tensor:
    return torch.einsum(spec, q.float(), k.float()) * scale


def _qkv(x: torch.Tensor, p, cfg: ModelConfig, positions, sh):
    """Roped q, k and v (B, S, heads, hd) of the heads this rank runs, and
    the KV head each of its query heads reads (None: ``repeat_interleave``
    by H / KV, as without a mesh)."""
    B, S, _d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    h0 = g0 = 0
    if sh is not None:
        q, h0 = sh.heads(q, "wq", H)
        k, g0 = sh.heads(k, "wk", KV)
        v, _ = sh.heads(v, "wv", KV)
    q = rope(q.reshape(B, S, -1, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, -1, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, -1, hd)
    rep = H // KV
    Hl, KVl = q.shape[2], k.shape[2]
    kv_of = None
    if (h0, Hl) != (rep * g0, rep * KVl):
        kv_of = torch.arange(h0, h0 + Hl, device=x.device) // rep - g0
    return q, k, v, kv_of


def _expand(kv: torch.Tensor, rep: int, kv_of) -> torch.Tensor:
    """Each query head's K or V (B, S, heads, hd): query head h reads KV
    head h // rep, as ``jnp.repeat`` pairs them (``Tensor.repeat`` would
    tile); ``kv_of`` maps a rank's query heads where its KV heads are not
    their block's."""
    if kv_of is None:
        return torch.repeat_interleave(kv, rep, dim=2)
    return kv.index_select(2, kv_of)


def attention(x: torch.Tensor, p, cfg: ModelConfig, *,
              positions: torch.Tensor, window: int = 0,
              cache: Optional[dict] = None, sh=None):
    """Full-sequence attention (train / prefill).  Returns (out,
    new_cache): when ``cache`` is given (prefill), K/V are written into
    its first S positions.

    When ``cfg.attn_chunk`` divides the sequence (and is shorter), scores
    are computed chunk by chunk with an online softmax (flash-attention
    structure), so the S×S matrix never materialises."""
    B, S, _d = x.shape
    hd = cfg.hd
    p = weights(p, sh)
    q, k, v, kv_of = _qkv(x, p, cfg, positions, sh)
    rep = cfg.n_heads // cfg.n_kv_heads
    kq = _expand(k, rep, kv_of)
    vq = _expand(v, rep, kv_of)
    C = cfg.attn_chunk
    if C and S > C and S % C == 0:
        out = _chunked_attention(q, kq, vq, positions, window)
    else:
        scores = _scores(q, kq, "bqhd,bkhd->bhqk", hd ** -0.5)
        keep = _mask(positions, positions, window)[:, None]
        scores = torch.where(keep, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vq)
    out = row(out.reshape(B, S, -1), p, "wo", sh)

    if cache is not None:
        _write(cache["k"], k, 0)
        _write(cache["v"], v, 0)
    return out, cache


def _chunked_attention(q, k, v, positions, window: int):
    """Online-softmax attention over KV chunks (flash structure).

    q, k, v: (B, S, H, hd); causal (+ optional sliding window).  Masked
    scores are -inf here (the dense path uses -1e30); ``m_safe`` and
    ``corr`` keep a row whose keys are all masked so far at zero."""
    B, S, H, hd = q.shape
    C = _chunk_of(S)
    scale = hd ** -0.5
    m = torch.full((B, H, S), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=q.device)
    for j0 in range(0, S, C):
        kj, vj, pj = k[:, j0:j0 + C], v[:, j0:j0 + C], positions[:, j0:j0 + C]
        s = _scores(q, kj, "bqhd,bkhd->bhqk", scale)
        keep = pj[:, None, :] <= positions[:, :, None]
        if window:
            keep &= pj[:, None, :] > positions[:, :, None] - window
        s = torch.where(keep[:, None], s, -torch.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p_ = torch.exp(s - m_safe[..., None])
        p_ = torch.where(keep[:, None], p_, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + torch.sum(p_, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p_.to(vj.dtype), vj).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return torch.movedim(out, 1, 2).to(q.dtype)            # (B, S, H, hd)


def _chunk_of(S: int, target: int = 1024) -> int:
    c = min(S, target)
    while S % c:
        c -= 1
    return c


def decode_attention(x: torch.Tensor, p, cfg: ModelConfig, *, cache: dict,
                     pos: int, window: int = 0, sh=None):
    """Single-token attention against the KV cache.  x: (B, 1, d); pos:
    the current position (an int).  Returns (out (B, 1, d), cache), the
    cache with this token's K/V written at ``pos``.

    ``cfg.gqa_grouped`` computes scores with the grouped-head einsum: the
    KV cache is read once instead of as an H/KV× repeated copy."""
    B = x.shape[0]
    hd = cfg.hd
    S = cache["k"].shape[1]
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    p = weights(p, sh)
    q, k, v, kv_of = _qkv(x, p, cfg, posb, sh)
    _write_decode(cache, k, v, pos)
    ck, cv = cache["k"], cache["v"]

    k_pos = torch.arange(S, device=x.device)
    keep = k_pos <= pos
    if window:
        keep &= k_pos > pos - window

    rep = cfg.n_heads // cfg.n_kv_heads
    if cfg.gqa_grouped and rep > 1 and kv_of is None:
        qg = q.reshape(B, 1, ck.shape[2], rep, hd)
        scores = _scores(qg, ck, "bqgrd,bkgd->bgrqk", hd ** -0.5)
        scores = torch.where(keep, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bgrqk,bkgd->bqgrd", w, cv)
        return row(out.reshape(B, 1, -1), p, "wo", sh), cache

    kq = _expand(ck, rep, kv_of)                           # (B, S, H, hd)
    vq = _expand(cv, rep, kv_of)
    scores = _scores(q, kq, "bqhd,bkhd->bhqk", hd ** -0.5)
    scores = torch.where(keep, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vq)
    return row(out.reshape(B, 1, -1), p, "wo", sh), cache


def _write_decode(cache: dict, k: torch.Tensor, v: torch.Tensor,
                  pos: int) -> None:
    """One decode step's K/V into the cache at ``pos``."""
    _write(cache["k"], k, pos)
    _write(cache["v"], v, pos)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cpu") -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
