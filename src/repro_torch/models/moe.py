"""Mixture-of-Experts layers: token-choice top-k routing, in PyTorch.

Interchangeable implementations over the same gates (numerics equal up to
summation order):

* ``dense`` — every expert computes every token, the gates combine them
  (E/k× the FLOPs of the active experts; the configurations' default).
* ``ragged`` — tokens sorted by expert, one ``torch.matmul`` per expert
  group (the reference's ``lax.ragged_dot``), dropless.
* ``capacity`` — GShard-style dispatch into an (E, C, d) buffer; (token,
  slot) pairs past an expert's capacity C drop to the residual path.
* ``a2a`` — the reference's expert-parallel all-to-all dispatch; the port
  runs it as the capacity dispatch, as the reference does without a mesh
  (its all-to-all waits with the dry-run's ``--optimized`` arm, ROADMAP.md
  queue A item 7.4).

Under a mesh (``sh``, :mod:`.sharded`) every form computes the rank's
experts only where the experts are sharded over ``model`` (expert
parallelism), or each expert's block of ff columns (ff-TP), and reduces
the partial sums over the model group.  The router is replicated, so
every rank routes every token alike.

Every combine is deterministic: a token's k contributions are summed in
slot order (no ``index_add_``, whose CUDA form sums with float atomics);
under a mesh a rank sums its own experts' contributions in slot order
(the others' are zero) before the reduction.
Sorting by expert is stable, as ``jnp.argsort`` is, so the tokens that
``capacity`` drops are the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import _gelu, normal
from .sharded import weights


def moe_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The router (d, E) and the experts' weights w1 (E, d, f), w2 (E, f,
    d) and, for the gated kinds, w3 (E, d, f), drawn from ``gen`` (fp32,
    see :func:`~repro_torch.models.layers.normal`)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"router": normal(gen, (d, e), s_in),
         "w1": normal(gen, (e, d, f), s_in),
         "w2": normal(gen, (e, f, d), s_out)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w3"] = normal(gen, (e, d, f), s_in)
    return p


def _gates(x: torch.Tensor, router: torch.Tensor, k: int,
           with_aux: bool = True):
    """(T, E) normalized top-k gate weights (in x's dtype), the top-k
    weights and experts (T, k), and the load-balance aux loss (fp32; None
    unless ``with_aux``)."""
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, topi, topv)    # (T, E)
    if not with_aux:
        return gates.to(x.dtype), topv, topi, None
    # Switch-style load-balance aux loss
    e = probs.shape[-1]
    frac = torch.mean((gates > 0).float(), dim=0)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))
    return gates.to(x.dtype), topv, topi, aux


def _act(cfg: ModelConfig):
    return F.silu if cfg.mlp_type == "swiglu" else _gelu


def _experts(h_in: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Every expert's MLP over its own rows: h_in (E, R, d) -> (E, R, d),
    one batched matmul per weight (x broadcast over E reads no copy)."""
    h = _act(cfg)(h_in @ p["w1"])
    if "w3" in p:
        h = h * (h_in @ p["w3"])
    return h @ p["w2"]


def _experts_of(cfg: ModelConfig, sh):
    """(first expert, count, partial): the experts this rank holds, and
    whether its outputs are partial sums to reduce over the model group
    (expert- or ff-parallel weights)."""
    E = cfg.n_experts
    if sh is None:
        return 0, E, False
    d = sh.tp_dim("w1")
    if d == 0:                       # expert parallel: a block of experts
        return sh.r * (E // sh.tp), E // sh.tp, True
    return 0, E, d == 2              # ff-TP: every expert's ff block


def _slot_sum(y: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): each token's k contributions summed in slot
    order."""
    out = y[:, 0]
    for j in range(1, y.shape[1]):
        out = out + y[:, j]
    return out


def moe_dense(x: torch.Tensor, p, cfg: ModelConfig, *,
              with_aux: bool = True, sh=None):
    """x: (T, d) -> (T, d).  All experts compute, gates combine."""
    gates, _, _, aux = _gates(x, p["router"], cfg.top_k, with_aux)
    y = _experts(x[None], p, cfg)                            # (E, T, d)
    e0, El, partial = _experts_of(cfg, sh)
    if El != cfg.n_experts:
        gates = gates[:, e0:e0 + El]
    out = torch.einsum("etd,te->td", y, gates).to(x.dtype)
    return (sh.reduce(out) if partial else out), aux


def moe_ragged(x: torch.Tensor, p, cfg: ModelConfig, *,
               with_aux: bool = True, sh=None):
    """Dropless sort-based routing: one matmul per expert group."""
    T, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    _, topv, topi, aux = _gates(x, p["router"], k, with_aux)
    flat_e = topi.reshape(-1)                                # (T*k,)
    flat_w = topv.reshape(-1).to(x.dtype)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)
    xs = torch.repeat_interleave(x, k, dim=0)[order]         # sorted
    sizes = torch.bincount(flat_e, minlength=e).tolist()
    e0, El, partial = _experts_of(cfg, sh)
    # another rank's experts contribute zero here
    y = torch.empty_like(xs) if El == e else torch.zeros_like(xs)
    start = 0
    for j, n in enumerate(sizes):
        if n and e0 <= j < e0 + El:
            rows = xs[start:start + n]
            y[start:start + n] = _experts(
                rows[None], {w: p[w][j - e0:j - e0 + 1]
                             for w in ("w1", "w2", "w3") if w in p}, cfg)[0]
        start += n
    y = y[inv] * flat_w[:, None]
    out = _slot_sum(y.reshape(T, k, d)).to(x.dtype)
    return (sh.reduce(out) if partial else out), aux


def _dispatch(topi: torch.Tensor, e: int, capacity_factor: float):
    """The capacity dispatch of (token, slot) pairs: (order, slot, keep,
    C) — the stable sort by expert, each ranked pair's row in the (E·C)
    buffer, whether it fits its expert's capacity C."""
    T, k = topi.shape
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    ranked_e = flat_e[order]
    # position within the expert group: running index minus group start
    starts = torch.searchsorted(ranked_e, torch.arange(e, device=topi.device),
                                side="left")
    pos_in_grp = torch.arange(T * k, device=topi.device) - starts[ranked_e]
    C = max(1, int(T * k / e * capacity_factor))
    keep = pos_in_grp < C
    slot = ranked_e * C + pos_in_grp
    return order, slot, keep, C


def moe_capacity(x: torch.Tensor, p, cfg: ModelConfig,
                 capacity_factor: float = 1.25, *, with_aux: bool = True,
                 sh=None):
    """GShard-style capacity dispatch: (token, slot) pairs sorted by
    expert fill a (E, C, d) buffer, each expert runs its rows, results
    gather back; pairs past capacity contribute 0 (the residual path).
    The reference writes them to an overflow row it discards; here they
    are not written."""
    T, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    _, topv, topi, aux = _gates(x, p["router"], k, with_aux)
    order, slot, keep, C = _dispatch(topi, e, capacity_factor)
    tok_of = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * C, d), dtype=x.dtype, device=x.device)
    buf[slot[keep]] = x[tok_of[order][keep]]
    e0, El, partial = _experts_of(cfg, sh)
    if El != e:                      # this rank's experts' rows only
        ranked_e = topi.reshape(-1)[order]
        keep = keep & (ranked_e >= e0) & (ranked_e < e0 + El)
        buf, slot = buf[e0 * C:(e0 + El) * C], slot - e0 * C
    y = _experts(buf.reshape(El, C, d), p, cfg).reshape(El * C, d)
    ranked_w = topv.reshape(-1).to(x.dtype)[order]
    contrib = torch.where(keep[:, None],
                          y[torch.clamp(slot, 0, El * C - 1)]
                          * ranked_w[:, None], 0.0)
    # back to (token, slot) order, then each token's slots in order
    contrib = contrib[torch.argsort(order)]
    out = _slot_sum(contrib.reshape(T, k, d)).to(x.dtype)
    return (sh.reduce(out) if partial else out), aux


def capacity_dropped(x: torch.Tensor, p, cfg: ModelConfig,
                     capacity_factor: float = 1.25) -> int:
    """How many (token, slot) pairs :func:`moe_capacity` drops on ``x``
    at ``capacity_factor``."""
    _, _, topi, _ = _gates(x, p["router"], cfg.top_k)
    _o, _s, keep, _c = _dispatch(topi, cfg.n_experts, capacity_factor)
    return int((~keep).sum())


def moe_a2a(x: torch.Tensor, p, cfg: ModelConfig,
            capacity_factor: float = 1.25, *, with_aux: bool = True,
            sh=None):
    """Expert-parallel dispatch.  Without a mesh the reference falls back
    to the local capacity dispatch; the port always runs it (under a mesh
    on the rank's experts, reduced), its all-to-all waiting with the
    dry-run tools (ROADMAP.md queue A item 7.4)."""
    return moe_capacity(x, p, cfg, capacity_factor, with_aux=with_aux,
                        sh=sh)


def moe(x: torch.Tensor, p, cfg: ModelConfig, *, with_aux: bool = True,
        sh=None):
    """x: (B, S, d) -> (B, S, d), plus the load-balance aux scalar (None
    unless ``with_aux``: decode needs none)."""
    B, S, d = x.shape
    fn = {"ragged": moe_ragged, "capacity": moe_capacity,
          "dense": moe_dense, "a2a": moe_a2a}[cfg.moe_impl]
    out, aux = fn(x.reshape(B * S, d), weights(p, sh), cfg,
                  with_aux=with_aux, sh=sh)
    return out.reshape(B, S, d), aux
