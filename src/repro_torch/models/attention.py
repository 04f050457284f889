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
of the cache's heads, and reduces ``wo``'s partial sums (under
``activation_rules(mesh, "sp")`` reduce-scatters them along the
sequence).  ``constrain`` marks the reference's ``"bthd"`` points.

Training and prefill attend over positions 0 .. S − 1.  Where
``cfg.attn_chunk`` splits the sequence, the card runs the hand-written
kernel (:func:`repro_torch.kernels.attention.flash`) and the CPU the torch
block loop :func:`_chunked_attention`, its plain version: both visit only
the key blocks inside a query block's causal window.  A layer's rope is
plain RoPE, or YaRN (``rope_kind="yarn"``: ``cfg.yarn``'s frequencies and
scale, as Hugging Face's ``_compute_yarn_parameters``).  Each layer runs
inside the span ``attn.window`` or ``attn.full`` (forward and backward).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from .layers import normal
from repro_torch.dist.sharding import constrain
from .sharded import enter, proj, row, weights


def rope_freqs(hd: int, theta: float, yarn: tuple = (), device=None):
    """(the rotate-half inverse frequencies θ^(−i/half), (hd/2,) fp32, and
    the scale of cos and sin).  With ``yarn`` = (factor, original context,
    beta_fast, beta_slow, attention factor), Hugging Face's
    ``_compute_yarn_parameters``: from the dimension whose wavelength turns
    beta_fast times in the original context (floored) to the one that
    turns beta_slow times (ceiled), clamped to [0, hd − 1], a linear ramp
    from the frequency to it over the factor; cos and sin scaled by the
    attention factor."""
    half = hd // 2
    i = torch.arange(0, half, dtype=torch.float32, device=device)
    freqs = theta ** (-i / half)
    if not yarn:
        return freqs, 1.0
    factor, original, beta_fast, beta_slow, mscale = yarn

    def dim_of(turns):
        return hd * math.log(original / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim_of(beta_fast)), 0)
    high = min(math.ceil(dim_of(beta_slow)), hd - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((i - low) / (high - low), 0.0, 1.0)
    return freqs * (1 - ramp) + (freqs / factor) * ramp, float(mscale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         yarn: tuple = ()):
    """x: (B, S, H, hd); positions: (B, S); ``yarn``: see
    :func:`rope_freqs`."""
    hd = x.shape[-1]
    half = hd // 2
    freqs, mscale = rope_freqs(hd, theta, yarn, x.device)
    ang = positions[..., None].float() * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    if yarn:
        cos, sin = cos * mscale, sin * mscale
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


def _qkv(x: torch.Tensor, p, cfg: ModelConfig, positions, sh,
         yarn: tuple = ()):
    """Roped q, k and v (B, S, heads, hd) of the heads this rank runs, and
    the KV head each of its query heads reads (None: ``repeat_interleave``
    by H / KV, as without a mesh)."""
    B, S, _d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xe = enter(x, sh)
    q, k, v = (proj(x, xe, p, w, sh) for w in ("wq", "wk", "wv"))
    h0 = g0 = 0
    if sh is not None:
        q, h0 = sh.heads(q, "wq", H)
        k, g0 = sh.heads(k, "wk", KV)
        v, _ = sh.heads(v, "wv", KV)
        if q.shape[-1] < H * hd and k.shape[-1] == KV * hd:
            # the rank's query heads read whole K / V
            k, v = sh.enter(k), sh.enter(v)
    q = rope(constrain(q.reshape(B, S, -1, hd), "bthd"), positions,
             cfg.rope_theta, yarn)
    k = rope(constrain(k.reshape(B, S, -1, hd), "bthd"), positions,
             cfg.rope_theta, yarn)
    v = constrain(v.reshape(B, S, -1, hd), "bthd")
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
              cache: Optional[dict] = None, sh=None,
              rope_kind: str = "default"):
    """Full-sequence attention (train / prefill) over positions 0 .. S −
    1.  Returns (out, new_cache): when ``cache`` is given (prefill), K/V
    are written into its first S positions.

    When ``cfg.attn_chunk`` divides the sequence (and is shorter), scores
    are computed block by block with an online softmax (flash-attention
    structure), so the S×S matrix never materialises: on the card by the
    attention kernel, elsewhere by :func:`_chunked_attention`."""
    name = "attn.window" if window else "attn.full"
    with spans.span(name):
        out = _attention(x, p, cfg, positions, window, cache, sh,
                         cfg.yarn if rope_kind == "yarn" else ())
    spans.backward_span(name, x, out)
    return out, cache


def _attention(x, p, cfg: ModelConfig, positions, window: int, cache, sh,
               yarn: tuple):
    B, S, _d = x.shape
    hd = cfg.hd
    p = weights(p, sh)
    q, k, v, kv_of = _qkv(x, p, cfg, positions, sh, yarn)
    rep = cfg.n_heads // cfg.n_kv_heads
    C = cfg.attn_chunk
    if C and S > C and S % C == 0 and x.device.type == "cuda":
        from repro_torch.kernels.attention import flash
        out = flash(q, k, v, window, kv_of)
    elif C and S > C and S % C == 0:
        out = _chunked_attention(q, _expand(k, rep, kv_of),
                                 _expand(v, rep, kv_of), positions, window)
    else:
        kq, vq = _expand(k, rep, kv_of), _expand(v, rep, kv_of)
        scores = _scores(q, kq, "bqhd,bkhd->bhqk", hd ** -0.5)
        keep = _mask(positions, positions, window)[:, None]
        scores = torch.where(keep, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vq)
    out = row(out.reshape(B, S, -1), p, "wo", sh, seq=True)

    if cache is not None:
        _write(cache["k"], k, 0)
        _write(cache["v"], v, 0)
    return out


def _chunked_attention(q, k, v, positions, window: int):
    """Online-softmax attention in blocks of C queries and C keys (flash
    structure), visiting for each query block only the key blocks inside
    its causal window (those past it would add exactly nothing), as the
    kernel does at its own block size.

    q, k, v: (B, S, H, hd) at positions 0 .. S − 1; causal (+ optional
    sliding window).  Masked scores are -inf here (the dense path uses
    -1e30); ``m_safe`` and ``corr`` keep a row whose keys are all masked so
    far at zero."""
    from repro_torch.kernels.attention import key_blocks
    B, S, H, hd = q.shape
    C = _chunk_of(S)
    scale = hd ** -0.5
    outs, tiles = [], 0
    for i0 in range(0, S, C):
        qi, pi = q[:, i0:i0 + C], positions[:, i0:i0 + C]
        n = qi.shape[1]
        m = torch.full((B, H, n), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, n, hd), dtype=torch.float32,
                          device=q.device)
        for jb in key_blocks(i0, S, window, C):
            j0 = jb * C
            kj, vj = k[:, j0:j0 + C], v[:, j0:j0 + C]
            pj = positions[:, j0:j0 + C]
            s = _scores(qi, kj, "bqhd,bkhd->bhqk", scale)
            keep = pj[:, None, :] <= pi[:, :, None]
            if window:
                keep &= pj[:, None, :] > pi[:, :, None] - window
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
            tiles += 1
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    spans.count("attn.blocks", B * H * tiles)
    out = torch.cat(outs, dim=2)
    return torch.movedim(out, 1, 2).to(q.dtype)            # (B, S, H, hd)


def _chunk_of(S: int, target: int = 1024) -> int:
    c = min(S, target)
    while S % c:
        c -= 1
    return c


def decode_attention(x: torch.Tensor, p, cfg: ModelConfig, *, cache: dict,
                     pos: int, window: int = 0, sh=None,
                     rope_kind: str = "default"):
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
    q, k, v, kv_of = _qkv(x, p, cfg, posb, sh,
                          cfg.yarn if rope_kind == "yarn" else ())
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
